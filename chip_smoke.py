#!/usr/bin/env python3
"""Builds and drives the PyTorch/CUDA port (src/repro_torch) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (exit code other than 0, no result line):

 1. device  - a CUDA card must be present; prints its name and power limit
              as nvidia-smi gives them; TF32 off for matmuls and cuDNN.
 2. build   - compiles the CUDA kernels (src/repro_torch/kernels/csrc, one
              nvcc per source, in parallel) into build/repro_torch.
 3. data    - a PubMed-shaped corpus from the paper's Table 1, made on the
              card from --seed: n = 141,043 attributes, 47 categories,
              199 non-missing attributes per row on average (normal spread
              15%, clipped to [1, 298]), attributes drawn Zipf(1.1)
              without replacement, padded COO of width 298; and 4,096
              more such rows as dense (4,096, 141,043) int32 rows, 0 =
              missing (2.3 GB).  d = 4096 (theory.sketch_dim(199) = 4017,
              rounded up).
 4. main    - the README quickstart path through the port's QueryEngine,
              once per metric ("cham", "hamming"): add_sparse of 524,288
              rows in chunks of 16,384, add_dense of the 4,096 dense rows,
              remove 1%, compact, topk (k=10) for 256 COO queries, radius
              for 64 queries at r = the median 10th-neighbour distance,
              pairwise for 64 queries against 4,096 ids.  Every answer is
              held against a brute-force scan of the plain PyTorch
              versions on the card over the alive rows: ids and distances
              must be equal, bit for bit, under both metrics (the kernels
              and the plain versions read one Cham table).  The launch
              counts are set to 0 just before this phase and each index
              kernel's must have risen just after.  The largest band-walk
              chunk each topk handed the top-k kernel (pow2-padded rows,
              fewer of them valid) is kept.  After the counts are read,
              each engine's topk call is timed on 5 fresh batches of 256
              queries (none answered from the engine's result cache; each
              held against brute force), and each rate is printed beside
              the median.
 5. frontdoor - the cham engine of the main phase behind one
              repro_torch.serve.FrontDoor: 4 client threads submit 256
              fresh COO topk queries (k=10) and 64 radius queries (the
              main phase's r) in requests of 8 rows; the launch counts
              are set to 0 just before and B1-B4 must have risen just
              after.  Every answer must equal a direct engine.topk /
              engine.radius on the same queries bit for bit, and 16 of
              them the brute-force scan.  An expired Deadline must give
              topk_budgeted a partial answer with cert_gap > 0, unfilled
              slots (-1, inf) and every returned id at its true distance;
              a deadline that never fires must give the exact answer,
              through the door and through topk_budgeted.  render_prom's
              engine_query_latency_ms counts must equal the calls made,
              and export_trace must write Chrome JSON holding the
              engine.topk and frontdoor.flush spans.  A COO batch of
              width 0 goes through add_sparse and topk of a small engine
              on the card (no B1 launch of width 0; answers against brute
              force), and B2 takes q, b and both as views off 16 bytes at
              k = 10 and 1,025, bit-identical to the plain version.  For
              the record: queries/s through the door, and of 5 direct topk
              calls on fresh batches with obs.configure(True) and 5 with
              (False), in turns.
 6. cluster - k-medoid clustering attached to the main phase's cham engine
              (PubMed at full width, d = 4096, about 519,000 rows alive),
              with the launch counts set to 0 just before and B2-B4 risen
              just after: engine.cluster(16, seed) (k = 16 as the
              reference's bench_cluster; kmode's default n_iter 15; the
              full-batch refit runs at attach).  The refit labels must
              equal a one-shot brute-force assignment against the medoids
              over the plain versions on the card (first minimum), and
              counts and weights the bincounts; 16,384 fresh rows through
              add_sparse must be labelled as brute force labels them, and
              16,384 more through assign_packed; after removing 1% the
              counts follow; save then restore of the engine and the index
              give equal state, and a refit (n_iter 1) of each identical
              medoids and labels.  On a 16,384-row sample, kmode_packed
              (full batch, n_iter 4) on the card must equal the same run
              on CPU tensors through the plain versions, bit for bit; mini-batch
              (slices of 4,096 rows, n_iter 2) over 65,536 rows must give
              the same result twice, labels an assignment against its
              centres.  render_prom must hold engine_query_latency_ms
              {op="assign"} and cluster_refits_total, the trace the
              cluster.refit and cluster.assign spans.  The index detaches
              at the end.  For the record: refit seconds and labels/s
              (rows x n_iter / wall, as benchmarks/bench_cluster.py
              counts), rows/s of add_sparse with assignment and of
              assign_packed alone, mini-batch labels/s.
 7. lifecycle - the cham engine's configuration (PubMed at full width,
              d = 4096) through the index's lifecycle on the card, with
              the launch counts set to 0 just before and B1-B4 risen just
              after.  Merge: engine A ingests rows [0, 262,144), engine B
              rows [262,144, 524,288) with its id counter offset to
              262,144 (chunks of 16,384), A.merge(B): store_merges_total
              reads 1, and A's packed rows, ids and weights equal a
              sequential build's.  Shard: A.shard(n_shards=4):
              stats()["n_shards"] and engine_shards read 4, with one
              partition_rows label set a shard; answers equal A's before
              the shard, then 16,384 more rows and 1% removed.  Migrate:
              to d = theory.sketch_dim(p95 of the rows' nnz) (5,555 for
              p95 247: W = 174 words, not a multiple of 4, so B2 and B3
              take their 4-byte copies) in batches of 16,384, drive
              "manual", journaled every 8 batches; at a journal step near
              half way 16,384 rows are added (the fresh tier), pairwise
              must raise, engine_migration_progress lie in (0, 1), and
              QueryEngine.restore(journal) must answer as A; migrate_all
              on both, after which each holds a fresh build's packed bits
              at the new spec.  Save / restore: A.save, QueryEngine.restore
              answer alike.  Every topk (256 queries, k = 10) and radius
              (64 queries) answer is held against brute force over the
              plain versions (mid-migration each tier in its own sketch
              space, merged by (value, id)) or against the engine that
              must answer the same, bit for bit.  For the record: ingest,
              merge, shard rebuild, migration rows/s with and without
              its journal steps (each save timed), save / restore
              seconds (and the snapshot trees' host copies), snapshot
              MB, and topk
              queries/s unsharded (the restored engine) against 4 shards
              (A), 5 fresh batches each, in turns.
 8. corpus  - 16,384 token documents from the port's synthetic_documents at
              llama3-8B's vocabulary (128,256), mean length 512,
              dup_fraction 0.1, made on the host from --seed (about 1.2 ms
              a document, the generator's own cost: the phase's cut), with
              the launch counts set to 0 just before each step and B1-B4
              risen over the phase.  The engines' d is
              theory.sketch_dim(p95 of the documents' distinct tokens)
              (13,161 for p95 439: W = 412).  Under each metric,
              bulk_ingest over 4 shards (4 worker threads, windows of 512,
              no dedup) must equal the sequential ingest_documents bit for
              bit: ids, packed rows, weights and the raw archive, and its
              launches be counted exactly (one B1 and one B4 a window, one
              B4 a store merge); the cham bulk load again with one worker.  ingest_documents with dedup_threshold
              40.0 on the card must keep the same documents, under the
              same ids, as on a device="cpu" engine.  dedup_by_sketch over
              all 16,384 sketches (banded) must return the DedupResult of
              the tiled scan, of dedup_by_sketch_blocked and of a brute-
              force scan of the plain versions on the card.  16 batches of
              BatchPipeline(vocab 128,256, seq_len 2,048, global_batch 8,
              dedup on) on the card must equal those of device="cpu", and
              topk (k = 10) of 256 kept documents brute force.  For the
              record: documents/s sequential and bulk, dedup seconds,
              pipeline batches/s.
 9. paper   - every figure function of repro_torch.experiments.paper (the
              twin of benchmarks/bench_paper.py: Figs 2-10, Tables 3-4,
              Theorem 2) on each of the paper's six Table 1 datasets at
              full width (n up to 1,306,127 for BrainCell, density and
              categories unscaled), 2,000 rows each (BrainCell's whole
              count; NIPS its whole 1,500; the clustering figures on as
              many rows of 4 clusters),
              drawn on the host by the port's generator in 2 worker
              processes started when the corpus phase ends (no earlier
              phase shares the host with them; this phase waits for
              them and prints how long).  Each figure keeps
              its twin's ratio of sketch dimension to density: d = twin d
              / twin scale, rounded up to 32 (printed).  The launch counts
              are set to 0 just before and B3-B5 must have risen just
              after.  Every ordering the reference asserts must hold (all
              figures run first, then the phase fails naming each that did
              not); Table 3's speedups are printed with the card's name
              and power limit (none asserted, as in the reference).  Then
              the four baseline sketches of 4 rows a dataset on the card
              must equal the same functions on CPU copies, and B5 (all
              rows, at every figure's d and Theorem 2's), B4 (all rows'
              sketches at the widest of these d) and B3 (its whole
              all-pairs output on those sketches, both outputs, and on
              the exact distances' (attribute, category) bitmaps, inner
              only, held on its first and last 64 rows, the last with
              the kernel's partial row tile) their plain versions bit for
              bit; the widest of each is timed with its bound (entry
              "paper_width").  Peak device memory is printed.
10. lm      - llama3-8B at full width and depth (32 layers, d_model 4096,
              32 heads / 8 KV heads, vocab 128,256, bf16), weights drawn on
              the card from --seed (16 GB).  ServeEngine.generate answers 4
              requests of 1,024 random prompt tokens, caches of 2,048
              positions, 32 greedy new tokens: first through the flash
              kernel (attention_impl None; the counts are set to 0 just
              before and flash_attention must read 32, one per layer of
              the one prefill, just after), then through the plain
              attention (attention_impl "ref").  The prefill logits of the
              two must agree to LOGIT_TOL, and each request's greedy
              tokens up to the first step where the plain run's top-1 /
              top-2 margin is under LOGIT_TOL; the logits each token was
              chosen from must agree to LOGIT_TOL wherever the two paths
              had the same tokens before it.  A short generate per path
              warms up first.  Prefill seconds, decode tokens/s and peak
              device memory are printed per path.  Layer by layer, each
              of the kernel path's 32 prefill attention outputs is held
              against the plain attention on the same inputs, within B6's
              tolerance (2 bf16 ulps of each row's largest |value|).
              Five more prefills per path are timed alone.
              Then three planted faults, each a generate through the plain
              path with the causal mask off by one (query i also sees key
              i + 1), in every layer, in the middle layer and in the last
              layer alone: the per-layer check must flag exactly the
              faulty layers, the end-to-end rule must reject the fault in
              every layer, and its readings under each fault are printed
              beside the sound ones.  Then the dense weights, engines
              and logits are freed (what stays on the card beyond the
              recorded attention call must be under 64 MiB, printed) and
              llama3-8B runs again with CabinEmbed (16,384 buckets,
              this phase's choice, k = 2; weights from the same
              generator): hashed_embed on the card must equal the CPU's
              on copies bit for bit and hashed_logits agree to 2**-10 of
              the largest |logit|; a generate of 4 requests of 1,024
              tokens and 8 greedy new tokens through the kernel path (32
              flash launches, counted apart as "cabinembed_launches") and
              the plain path must pass the end-to-end rule, and each of
              the kernel path's 32 prefill attention outputs B6's
              tolerance.  Its parameter count is printed beside the dense
              model's.
11. kernels - each kernel against its plain version on the card, at the
              shapes the main path gave it: B1-B5 bit for bit (B2 also at
              the kept band-walk chunks; B5 also against the sparse plain
              version of the same rows), B6 on the prefill's first
              attention inputs within 2 bf16 ulps of each row's largest
              |value| (the tensor-core kernel), and again in float32 at
              batch 1 within 1e-5 (the scalar kernel).  Beyond the main
              path's shapes: B2 at k = 1,024 for 16 queries over the alive
              store (one pass, one select and one merge launch, counted),
              B1 and B5 on 256 rows at d = 2,000,001 (above the
              shared-memory bitmap), bit for bit; `cuobjdump -sass` of the
              built flash library must show HMMA (tensor-core)
              instructions in every bf16 instance, whose registers / stack
              / local memory (`-res-usage`) are printed; every B2 select
              instance must show IMMA (int8 mma.sync) and every B3
              pair-stats instance IGMMA (int8 wgmma) tensor-core
              instructions, and they and every B1 instance use no stack
              and no local memory.  B3 is also held against its plain
              version at ragged edge shapes, every output switch.  B2's
              plan (query tile BQ, splits S, scratch bytes) is printed for
              each of its shapes, and B1's (slots a load, rows a block).
              B1, B2 at the main shape, B3 at both of the main path's
              calls (inner only for cham, hamming only for hamming), B6
              and SDPA are timed over 5 runs each; B1 beside one
              streaming add of its two inputs (a yardstick of the memory
              rate at this size, not the same function) and over four
              chunks in one launch (its rate apart from its per-launch
              cost).
              Kernel time, plain time and the bound: the largest of the
              bytes moved over 3.35 TB/s (the H100 SXM's HBM rate), the
              32-bit integer operations over 64 per clock per SM and the
              population counts over 16 per clock per SM (CUDA C++
              Programming Guide, arithmetic instruction throughput,
              compute capability 9.0) at this card's SM count and maximum
              SM clock, bf16 flops over 989 TFLOP/s and int8 operations
              (B2's and B3's inner products) over 1,979 TOP/s (data
              sheet).  For B6 also the time of PyTorch's
              scaled_dot_product_attention on the same inputs
              (library_ms, a yardstick the port never calls).
              Last, B1-B4 at the lifecycle phase's migrated width, bit for
              bit and timed with their bounds (each kernel's entry
              "migrated_width"): B1 on a 16,384-row chunk, B2 for 256
              queries over the migrated store at k = 10, B3 for 64 queries
              x 65,536 rows, B4 over the migrated store.  And at the
              corpus phase's width (entry "corpus_width"): B1 on one
              512-document window, B2 for the 256 kept documents over the
              bulk engine at k = 10, B3 on the corpus dedup's widest
              banded strip, B4 over the corpus.
12. output  - one JSON line of the lifecycle, cluster, corpus and paper
              phases' records and the CabinEmbed run's, the nvidia-smi
              line, one JSON line listing the kernels (with the launches
              of the main path, the frontdoor, lifecycle, cluster, corpus
              and paper phases and the CabinEmbed run), and last the line
              {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import itertools
import json
import multiprocessing
import re
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import obs  # noqa: E402
from repro_torch.cluster import ClusterIndex  # noqa: E402
from repro_torch.configs.base import ParallelConfig  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core import (allpairs, baselines, hashing,  # noqa: E402
                              packing, theory)
from repro_torch.core.cabin import CabinParams, binem  # noqa: E402
from repro_torch.core.cham import cham_from_table, cham_table  # noqa: E402
from repro_torch.core.kmode import kmode_packed  # noqa: E402
from repro_torch.data import dedup as dedup_mod  # noqa: E402
from repro_torch.data.dedup import (dedup_by_sketch,  # noqa: E402
                                    dedup_by_sketch_blocked)
from repro_torch.device import nonzero_2d  # noqa: E402
from repro_torch.experiments import paper  # noqa: E402
from repro_torch.data.pipeline import (BatchPipeline,  # noqa: E402
                                       PipelineConfig, synthetic_documents)
from repro_torch.index import (QueryEngine, bulk_ingest,  # noqa: E402
                               ingest_documents)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.cabin_build import ops as dense_ops  # noqa: E402
from repro_torch.kernels.cabin_build_sparse import (  # noqa: E402
    ops as sparse_ops)
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.hamming import ops as hamming_ops  # noqa: E402
from repro_torch.kernels.topk_select import ops as topk_ops  # noqa: E402
from repro_torch.models import hashed_embedding as hemb  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve import Deadline, FrontDoor, ServeEngine  # noqa: E402

# PubMed, the paper's Table 1 (repro/data/synthetic.py TABLE1["pubmed"])
N_DIMS, N_CATEGORIES, DENSITY = 141043, 47, 199
M_SLOTS = int(DENSITY * 1.5)  # 298, the reference sampler's COO width
SKETCH_DIM = 4096
N_ROWS = 524288  # rows ingested per engine: 256 MiB of sketches
N_DENSE = 4096  # dense rows ingested per engine: 2.3 GB of int32
CHUNK = 16384
ZIPF_A = 1.1
DRAWS = 1024  # Zipf draws per row; ~498 distinct on average, >= 298 needed
K = 10
N_TOPK_QUERIES, N_RADIUS_QUERIES, N_PAIRWISE_IDS = 256, 64, 4096
# beyond the main path: top-k at k = 1,024 (one pass of the kernel) for 16
# queries; Cabin above the shared-memory bitmap (d > 1,859,584)
BIG_K, BIG_K_QUERIES = 1024, 16
BIG_D, BIG_D_ROWS = 2_000_001, 256
# timed runs of B1, B2, B3 and B6 and of B6's library yardstick, prefills
# per LM path, and topk calls per metric
TIMED_RUNS = 5
INDEX_KERNELS = ("cabin_build", "cabin_build_sparse", "pair_stats",
                 "row_popcount", "topk_select")
# the frontdoor phase: client threads, query rows a request, the answers
# also held against brute force, queries a deadline check, rows of the
# width-0 check's engine, the top-k alignment check's shape, and direct
# topk calls timed with the recorder on and with it off, in turns
FD_CLIENTS, FD_REQ_ROWS, FD_SAMPLE = 4, 8, 16
FD_DEADLINE_QUERIES, FD_C1_ROWS = 8, 4096
FD_C2_QUERIES, FD_C2_ROWS = 16, 65536
FD_TIMED_CALLS = 5
# the lifecycle phase: shards of the merged engine, and migration batches
# between two journal steps
LC_SHARDS, LC_JOURNAL_EVERY = 4, 8
# the cluster phase: k and n_iter of the attached index (the reference's
# bench_cluster k and kmode's default n_iter), fresh rows assigned, the
# n_iter of the refits after save / restore, the sample held card against
# CPU (rows, n_iter: the CPU run's cost), and the mini-batch runs' rows,
# n_iter and slice
CL_K, CL_ITERS, CL_FRESH, CL_REFIT_ITERS = 16, 15, 16384, 1
CL_SAMPLE, CL_SAMPLE_ITERS = 16384, 4
CL_MB_ROWS, CL_MB_ITERS, CL_BATCH_ROWS = 65536, 2, 4096
# the corpus phase: documents at llama3-8B's vocabulary, their mean length
# and near-duplicate share, bulk ingest shards (and workers), the ingest
# window, the dedup threshold (the reference's ingest test's), topk
# queries; the batch pipeline's sequence length, global batch and batches
CORPUS_VOCAB, CORPUS_DOCS, CORPUS_MEAN_LEN, CORPUS_DUP = 128256, 16384, 512, 0.1
CORPUS_SHARDS, CORPUS_WINDOW, CORPUS_THRESHOLD = 4, 512, 40.0
CORPUS_QUERIES = 256
PIPE_SEQ, PIPE_BATCH, PIPE_BATCHES = 2048, 8, 16

# the paper phase: rows a figure (BrainCell's whole Table 1 count; NIPS
# has 1,500 and takes them all), the
# clusters of the clustering figures, the twins' (scale, dims) of
# benchmarks/bench_paper.py, rows of the card-against-CPU baseline check,
# B3's rows held to its plain version at each end of its output, worker
# processes drawing the rows; the kernels its figures launch
PAPER_ROWS, PAPER_K = 2000, 4
PAPER_TWINS = {"fig2": (0.08, (512,)), "fig3": (0.06, (128, 256, 512, 1024)),
               "fig4": (0.06, (256,)), "fig5": (0.06, (512,)),
               "fig6to10": (0.05, (256, 512)), "table4": (0.02, (1024,))}
PAPER_CPU_ROWS, PAPER_B3_ROWS, PAPER_WORKERS = 4, 64, 2
PAPER_KERNELS = ("cabin_build", "pair_stats", "row_popcount")
# the CabinEmbed run of the LM phase: its bucket count (this phase's own
# choice: the reference sets one only in a smoke test, 64) and k, and its
# greedy new tokens
HASHED_BUCKETS, HASHED_K, HASHED_NEW = 16384, 2, 8
# the card's hashed_logits against the CPU's: float32 sums of 4,096 bf16
# products in two orders, held to 2**-10 of the largest |logit| (a wrong
# bucket or sign moves a logit by its own size)
HASHED_LOGIT_RTOL = 2**-10

# the LM phase: llama3-8B at full width and depth, 4 requests of 1,024
# prompt tokens, caches of 2,048 positions, 32 greedy new tokens
LM_ARCH = "llama3_8b"
LM_BATCH, LM_PROMPT, LM_MAX_LEN, LM_NEW = 4, 1024, 2048, 32
# bytes the dense run may leave on the card beyond its recorded attention
# call once its weights are freed (its prompts and the allocator's
# rounding; one dense layer alone is 0.4 GiB)
LM_LEFT_SLACK = 2**26
# End-to-end tolerance of the kernel LM path against the plain one
# (attention_impl="ref"): the paths differ only in the attention's
# float32 summation order, which moves a bf16-rounded attention output by
# one ulp where it lies near a rounding boundary; 32 bf16 layers carry
# such flips on.  Prefill logits must agree to LOGIT_TOL absolute, and
# greedy tokens until the plain run's top-1 / top-2 margin falls under it.
# It catches gross faults; a fault confined to one layer may read under
# it, so each layer's attention is also held to B6's own tolerance.  The
# planted faults of the lm phase print what both checks read.
LOGIT_TOL = 0.25

# H100 SXM HBM rate (NVIDIA data sheet, at 700 W), and the sm_90 issue
# rates per clock per SM of 32-bit integer add / logic / shift / multiply
# and of population count (CUDA C++ Programming Guide, arithmetic
# instruction throughput, compute capability 9.0)
HBM_BYTES_PER_S = 3.35e12
INT32_PER_CLOCK_SM = 64
POPC_PER_CLOCK_SM = 16
# dense bf16 and int8 tensor-core rates of the H100 SXM (NVIDIA data
# sheet, 700 W)
BF16_FLOPS = 989e12
INT8_OPS = 1979e12

REPLACES = {
    "cabin_build": "src/repro/kernels/cabin_build/kernel.py:78",
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:82",
    "cabin_build_sparse": "src/repro/kernels/cabin_build_sparse/kernel.py:83",
    "topk_select": "src/repro/kernels/topk_select/kernel.py:103",
    "pair_stats": "src/repro/kernels/hamming/kernel.py:70",
    "row_popcount": "src/repro/kernels/hamming/kernel.py:141",
}
SOURCES = {
    "cabin_build": "src/repro_torch/kernels/csrc/cabin_build.cu",
    "flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
    "cabin_build_sparse": "src/repro_torch/kernels/csrc/cabin_build_sparse.cu",
    "topk_select": "src/repro_torch/kernels/csrc/topk_select.cu",
    "pair_stats": "src/repro_torch/kernels/csrc/hamming.cu",
    "row_popcount": "src/repro_torch/kernels/csrc/hamming.cu",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of fn() in ms, by CUDA events around each of `reps`
    runs, with the 50 MB L2 cache flushed before each (the main path meets
    its inputs cold: fresh ingest chunks, a store larger than L2)."""
    for _ in range(warmup):
        fn()
    scrub = torch.empty(2**25, dtype=torch.int32, device="cuda")  # 128 MiB
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    total = 0.0
    for _ in range(reps):
        scrub.zero_()
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        total += start.elapsed_time(stop)
    return total / reps


def nvidia_smi(query: str = "name,power.limit") -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def peak_rates() -> dict:
    """Operations per second of this card for each operation type."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    per_clock_sm = {"int32": INT32_PER_CLOCK_SM, "popc": POPC_PER_CLOCK_SM}
    return {"sms": sms, "mhz": mhz, "bf16": BF16_FLOPS, "int8": INT8_OPS, **{
        kind: n * sms * mhz * 1e6 for kind, n in per_clock_sm.items()}}


def bound(n_bytes: float, ops: dict, rates: dict) -> tuple[float, str]:
    """Least time in ms: bytes over the HBM rate, or each operation
    type's count over its peak rate, whichever is largest."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(n / rates[kind] * 1e3 for kind, n in ops.items())
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


def pubmed_rows(n: int, gen: torch.Generator, device) -> tuple[torch.Tensor,
                                                               torch.Tensor]:
    """Padded COO (indices, values) (n, 298) int32 on `device`.

    Per row: nnz ~ clip(N(199, 29.85), 1, 298) truncated, as the reference
    sampler; attributes are the first nnz distinct values of a stream of
    Zipf(1.1) draws, which is the same law as drawing them one by one
    without replacement; categories uniform in 1..47; 0 pads."""
    w = 1.0 / torch.arange(1, N_DIMS + 1, dtype=torch.float64,
                           device=device) ** ZIPF_A
    cdf = torch.cumsum(w / w.sum(), 0)
    cdf[-1] = 1.0
    indices = torch.zeros((n, M_SLOTS), dtype=torch.int32, device=device)
    values = torch.zeros((n, M_SLOTS), dtype=torch.int32, device=device)
    for r0 in range(0, n, CHUNK):
        rows = min(CHUNK, n - r0)
        nnz = torch.normal(float(DENSITY), DENSITY * 0.15, (rows,),
                           generator=gen, device=device)
        nnz = nnz.clamp(1, M_SLOTS).to(torch.int64)
        u = torch.rand((rows, DRAWS), generator=gen, dtype=torch.float64,
                       device=device)
        draws = torch.searchsorted(cdf, u).clamp_(max=N_DIMS - 1)
        srt, pos = torch.sort(draws, dim=1, stable=True)
        first_sorted = torch.ones_like(srt, dtype=torch.bool)
        first_sorted[:, 1:] = srt[:, 1:] != srt[:, :-1]
        first = torch.zeros_like(first_sorted).scatter_(1, pos, first_sorted)
        rank = torch.cumsum(first.to(torch.int64), 1) - 1
        keep = first & (rank < nnz[:, None])
        row_i, draw_j = torch.nonzero(keep, as_tuple=True)
        slot = rank[row_i, draw_j]
        indices[r0 + row_i, slot] = draws[row_i, draw_j].to(torch.int32)
        values[r0 + row_i, slot] = torch.randint(
            1, N_CATEGORIES + 1, (len(row_i),), generator=gen,
            device=device, dtype=torch.int32)
    return indices, values


def dense_rows(idx: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """The same rows as (n, 141,043) int32 dense categories, 0 = missing
    (a row's attributes are distinct, so no slot overwrites another)."""
    dense = torch.zeros((idx.shape[0], N_DIMS), dtype=torch.int32,
                        device=idx.device)
    row, slot = torch.nonzero(val, as_tuple=True)
    dense[row, idx[row, slot].long()] = val[row, slot]
    return dense


# ---------------------------------------------------------------------------
# brute force over the alive rows, with the plain versions
# ---------------------------------------------------------------------------


def plain_dist(q: torch.Tensor, rows: torch.Tensor, metric: str,
               d: int = SKETCH_DIM) -> torch.Tensor:
    if metric == "cham":
        inner, _ = hamming_ops.pair_stats_ref(q, rows, op_ham=False)
        table = cham_table(d, q.device, q.shape[1])
        return cham_from_table(table,
                               hamming_ops.row_popcount_ref(q)[:, None],
                               hamming_ops.row_popcount_ref(rows)[None, :],
                               inner)
    _, ham = hamming_ops.pair_stats_ref(q, rows, op_inner=False)
    return ham.to(torch.float32)


def largest_band_chunk(call):
    """Runs call() and returns its result and the largest (q, b, k,
    m_valid) it handed the top-k kernel with rows past m_valid masked, as
    the band walk's pow2-padded chunks are."""
    seen = []
    real = topk_ops.topk_select

    def spy(q, b, k, *, d, metric="cham", m_valid=None):
        if (m_valid is not None and m_valid < b.shape[0]
                and (not seen or m_valid > seen[0][3])):
            seen[:] = [(q, b, k, m_valid)]
        return real(q, b, k, d=d, metric=metric, m_valid=m_valid)

    topk_ops.topk_select = spy
    try:
        result = call()
    finally:
        topk_ops.topk_select = real
    check(bool(seen), "no band-walk chunk with masked rows reached the "
          "top-k kernel")
    return result, seen[0]


def main_path(metric: str, idx: torch.Tensor, val: torch.Tensor,
              dense: torch.Tensor, q_idx: torch.Tensor, q_val: torch.Tensor,
              rng: np.random.Generator, card: str) -> dict:
    """One engine through the quickstart path, checked against brute
    force.  Returns the queries' sketches, the alive store matrix and the
    largest band-walk chunk, for the kernel phases."""
    params = CabinParams.create(N_DIMS, SKETCH_DIM, seed=0)
    engine = QueryEngine(params, metric=metric, device=idx.device)
    n = idx.shape[0]
    ingest_s = ingest(engine, idx, val)
    t0 = time.perf_counter()
    dense_ids = engine.add_dense(dense)
    torch.cuda.synchronize()
    dense_s = time.perf_counter() - t0
    check(np.array_equal(dense_ids, np.arange(n, n + dense.shape[0])),
          f"{metric}: dense ids")
    n += dense.shape[0]
    check(len(engine) == n, f"{metric}: {len(engine)} rows after ingest")

    kill = rng.choice(engine.ids(), n // 100, replace=False)
    check(engine.remove(kill) == len(kill), "remove count")
    engine.compact()
    n_alive = n - len(kill)
    check(len(engine) == n_alive and engine.store.size == n_alive,
          "compact keeps exactly the alive rows")

    t0 = time.perf_counter()
    engine.sync_layout()
    layout_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (nn_ids, nn_d), band_chunk = largest_band_chunk(
        lambda: engine.topk((q_idx, q_val), K))
    topk_s = time.perf_counter() - t0
    check(nn_ids.shape == (N_TOPK_QUERIES, K) and np.isfinite(nn_d).all(),
          f"{metric}: topk shape/finite")

    rq = (q_idx[:N_RADIUS_QUERIES], q_val[:N_RADIUS_QUERIES])
    r = float(np.median(nn_d[:N_RADIUS_QUERIES, K - 1]))
    t0 = time.perf_counter()
    near = engine.radius(rq, r)
    radius_s = time.perf_counter() - t0

    sel_ids = np.sort(rng.choice(engine.ids(), N_PAIRWISE_IDS, replace=False))
    t0 = time.perf_counter()
    pw_ids, pw = engine.pairwise(rq, sel_ids)
    pairwise_s = time.perf_counter() - t0
    torch.cuda.synchronize()

    # brute force over the alive rows in id order, plain versions only
    mat, m_alive, alive_ids = engine.store.gather_alive()
    alive = mat[:m_alive].contiguous()
    q_sk = sparse_ops.cabin_build_sparse_ref(
        q_idx, q_val, d=SKETCH_DIM, psi_seed=params.psi_seed,
        pi_seed=params.pi_seed)
    bv, bpos = topk_ops.topk_select_ref(q_sk, alive, K, d=SKETCH_DIM,
                                        metric=metric)
    check(np.array_equal(alive_ids[bpos.cpu().numpy()], nn_ids),
          f"{metric}: topk ids differ from the brute-force scan")
    check(np.array_equal(bv.cpu().numpy(), nn_d),
          f"{metric}: topk distances differ from the brute-force scan")
    dist = plain_dist(q_sk[:N_RADIUS_QUERIES], alive, metric)
    hit = (dist < torch.tensor(r, dtype=torch.float32)).cpu().numpy()
    n_hits = 0
    for qi, got in enumerate(near):
        want = alive_ids[np.flatnonzero(hit[qi])]
        check(np.array_equal(got, want),
              f"{metric}: radius query {qi} differs from brute force")
        n_hits += len(got)
    pos = np.searchsorted(alive_ids, sel_ids)
    check(np.array_equal(pw_ids, sel_ids), "pairwise ids")
    check(np.array_equal(pw, dist[:, torch.from_numpy(pos).to(dist.device)]
                         .cpu().numpy()),
          f"{metric}: pairwise differs from brute force")
    n_sparse = n - dense.shape[0]
    log(f"[main:{metric}] ingest {n_sparse} sparse rows {ingest_s:.3f}s "
        f"({n_sparse / ingest_s:.1f} rows/s), {dense.shape[0]} dense rows "
        f"{dense_s:.3f}s ({dense.shape[0] / dense_s:.1f} rows/s), layout "
        f"{layout_s:.3f}s, "
        f"topk {N_TOPK_QUERIES} queries {topk_s:.3f}s "
        f"({N_TOPK_QUERIES / topk_s:.1f} queries/s), radius r={r:.4f} "
        f"{radius_s:.3f}s ({n_hits} hits), pairwise "
        f"{N_RADIUS_QUERIES}x{N_PAIRWISE_IDS} {pairwise_s:.3f}s [{card}]")
    return {"q_sk": q_sk, "alive": alive, "band_chunk": band_chunk,
            "engine": engine, "alive_ids": alive_ids, "r": r}


def time_topk(metric: str, run: dict, batches: list, card: str
              ) -> list[float]:
    """The main path's topk call on its engine, once for each of
    TIMED_RUNS fresh batches of N_TOPK_QUERIES COO queries (fresh, so that
    no call is answered from the engine's result cache), after the main
    path's launch counts were read: queries/s of each call, host clock
    (the answers come back to the host); each answer is held against the
    brute-force scan."""
    engine = run["engine"]
    rates = []
    for q_idx, q_val in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ids, dist = engine.topk((q_idx, q_val), K)
        rates.append(N_TOPK_QUERIES / (time.perf_counter() - t0))
        q_sk = sparse_ops.cabin_build_sparse_ref(
            q_idx, q_val, d=SKETCH_DIM, psi_seed=engine.params.psi_seed,
            pi_seed=engine.params.pi_seed)
        bv, bpos = topk_ops.topk_select_ref(q_sk, run["alive"], K,
                                            d=SKETCH_DIM, metric=metric)
        check(np.array_equal(run["alive_ids"][bpos.cpu().numpy()], ids)
              and np.array_equal(bv.cpu().numpy(), dist),
              f"{metric}: a timed topk call differs from brute force")
    log(f"[main:{metric}] topk {N_TOPK_QUERIES} fresh queries, "
        f"{TIMED_RUNS} calls: {rates} queries/s (median "
        f"{float(np.median(rates))} queries/s), each equal to brute force "
        f"[{card}]")
    return rates


# ---------------------------------------------------------------------------
# the front door
# ---------------------------------------------------------------------------


def brute_topk(q_sk: torch.Tensor, rows: torch.Tensor, row_ids: np.ndarray,
               metric: str, k: int = K, d: int = SKETCH_DIM
               ) -> tuple[np.ndarray, np.ndarray]:
    """The k nearest of `rows` by the plain top-k version: (ids, dists)."""
    bv, bpos = topk_ops.topk_select_ref(q_sk, rows, k, d=d, metric=metric)
    return row_ids[bpos.cpu().numpy()], bv.cpu().numpy()


def prom_counts(text: str, name: str) -> dict:
    """{op: count} of the histogram `name` in Prometheus text."""
    out = {}
    for line in text.splitlines():
        if line.startswith(name + "_count{"):
            label, value = line.rsplit(" ", 1)
            out[label.split('op="')[1].split('"')[0]] = int(value)
    return out


def off_16_bytes(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of t whose data starts 4 bytes past a 16-byte
    boundary."""
    buf = torch.empty(t.numel() + 4, dtype=t.dtype, device=t.device)
    start = next(s for s in range(4) if (buf.data_ptr() + 4 * s) % 16 == 4)
    view = buf[start:start + t.numel()].view(t.shape)
    view.copy_(t)
    return view


def frontdoor_phase(run: dict, gen: torch.Generator, calls: dict,
                    card: str) -> dict:
    """The cham engine of the main path served through one FrontDoor by
    FD_CLIENTS client threads, then its deadlines, flight recorder, the
    width-0 COO batch (C1) and top-k inputs off 16 bytes (C2) on the card.
    `calls` is the engine calls made before (op -> count).  Returns the
    launch counts of the served run and the phase's rates."""
    metric, engine = "cham", run["engine"]
    device = run["alive"].device
    params = engine.params
    sk_kw = dict(d=SKETCH_DIM, psi_seed=params.psi_seed,
                 pi_seed=params.pi_seed)
    q_idx, q_val = pubmed_rows(N_TOPK_QUERIES, gen, device)
    rq_idx, rq_val = pubmed_rows(N_RADIUS_QUERIES, gen, device)
    r = run["r"]
    check(prom_counts(engine.render_prom(), "engine_query_latency_ms")
          == calls, f"engine_query_latency_ms counts differ from the calls "
          f"made {calls}")
    calls = dict(calls)

    # -- served: FD_CLIENTS threads, each its share of both batches ------
    per_topk = N_TOPK_QUERIES // FD_CLIENTS
    per_radius = N_RADIUS_QUERIES // FD_CLIENTS
    answers: dict = {}
    errors: list = []
    obs.clear_trace()

    def client(c: int, fd: FrontDoor) -> None:
        try:
            handles = []
            for lo in range(c * per_topk, (c + 1) * per_topk, FD_REQ_ROWS):
                sl = slice(lo, lo + FD_REQ_ROWS)
                handles.append((("topk", lo), fd.submit(
                    "topk", (q_idx[sl], q_val[sl]), k=K)))
            for lo in range(c * per_radius, (c + 1) * per_radius,
                            FD_REQ_ROWS):
                sl = slice(lo, lo + FD_REQ_ROWS)
                handles.append((("radius", lo), fd.submit(
                    "radius", (rq_idx[sl], rq_val[sl]), r=r)))
            for key, h in handles:
                answers[key] = h.result(timeout=600)
        except BaseException as e:  # surfaced on the main thread
            errors.append(e)

    build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with FrontDoor(engine) as fd:
        threads = [threading.Thread(target=client, args=(c, fd))
                   for c in range(FD_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        served = fd.stats()
    served_s = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    check(not errors, f"a front-door client failed: {errors[:1]}")
    for kernel in ("cabin_build_sparse", "topk_select", "pair_stats",
                   "row_popcount"):
        check(launches[kernel] > 0, f"kernel {kernel} was not launched "
              "through the front door")
    n_req = (N_TOPK_QUERIES + N_RADIUS_QUERIES) // FD_REQ_ROWS
    check(served["answered"] == n_req == len(answers)
          and served["double_answers"] == 0,
          f"front door answered {served['answered']} of {n_req}")
    snap = engine.obs_snapshot()
    flushes = {op: snap["frontdoor_service_ms"][f"op={op}"]["count"]
               for op in ("topk", "radius")}
    calls["topk"] += flushes["topk"]
    calls["radius"] += flushes["radius"]

    # every answer against the engine's own on the same queries
    ids, dist = engine.topk((q_idx, q_val), K)
    near = engine.radius((rq_idx, rq_val), r)
    calls["topk"] += 1
    calls["radius"] += 1
    for (op, lo), res in answers.items():
        check(res.ok and not res.partial and res.cert_gap == 0.0,
              f"front-door {op} at {lo}: {res}")
        if op == "topk":
            check(np.array_equal(res.ids, ids[lo:lo + FD_REQ_ROWS])
                  and np.array_equal(res.dists, dist[lo:lo + FD_REQ_ROWS]),
                  f"front-door topk at {lo} differs from engine.topk")
        else:
            for got, want in zip(res.hits, near[lo:lo + FD_REQ_ROWS]):
                check(np.array_equal(got, want),
                      f"front-door radius at {lo} differs from "
                      "engine.radius")
    sample = sparse_ops.cabin_build_sparse_ref(q_idx[:FD_SAMPLE],
                                               q_val[:FD_SAMPLE], **sk_kw)
    bi, bd = brute_topk(sample, run["alive"], run["alive_ids"], metric)
    check(np.array_equal(bi, ids[:FD_SAMPLE])
          and np.array_equal(bd, dist[:FD_SAMPLE]),
          "front-door sample differs from the brute-force scan")

    # -- deadlines ---------------------------------------------------------
    e_idx, e_val = pubmed_rows(FD_DEADLINE_QUERIES, gen, device)
    e_ids, e_d, info = engine.topk_budgeted((e_idx, e_val), K,
                                            deadline=Deadline(timeout_ms=0))
    calls["topk"] += 1
    filled = e_ids >= 0
    check(info["partial"] and info["cert_gap"] > 0,
          f"an expired deadline gave {info}")
    check(np.array_equal(~filled, np.isinf(e_d)),
          "unfilled slots are not (-1, inf)")
    e_sk = sparse_ops.cabin_build_sparse_ref(e_idx, e_val, **sk_kw)
    true = plain_dist(e_sk, run["alive"], metric).cpu().numpy()
    pos = np.searchsorted(run["alive_ids"], e_ids[filled])
    check(np.array_equal(true[np.nonzero(filled)[0], pos], e_d[filled]),
          "a partial answer's id does not carry its true distance")
    with FrontDoor(engine) as fd:
        late = fd.submit("topk", (e_idx, e_val), k=K,
                         timeout_ms=0).result(timeout=60)
        f_idx, f_val = pubmed_rows(FD_DEADLINE_QUERIES, gen, device)
        far = fd.topk((f_idx, f_val), K, deadline=Deadline(timeout_ms=1e9))
    calls["topk"] += 1
    check(late.partial and late.timed_out and late.ids.shape
          == (FD_DEADLINE_QUERIES, 0), f"zero timeout gave {late}")
    f_sk = sparse_ops.cabin_build_sparse_ref(f_idx, f_val, **sk_kw)
    bi, bd = brute_topk(f_sk, run["alive"], run["alive_ids"], metric)
    check(not far.partial and np.array_equal(far.ids, bi)
          and np.array_equal(far.dists, bd),
          "a deadline that never fires differs from brute force")
    g_idx, g_val = pubmed_rows(FD_DEADLINE_QUERIES, gen, device)
    g_ids, g_d, g_info = engine.topk_budgeted(
        (g_idx, g_val), K, deadline=Deadline(timeout_ms=1e9))
    calls["topk"] += 1
    g_sk = sparse_ops.cabin_build_sparse_ref(g_idx, g_val, **sk_kw)
    bi, bd = brute_topk(g_sk, run["alive"], run["alive_ids"], metric)
    check(not g_info["partial"] and g_info["cert_gap"] == 0.0
          and np.array_equal(g_ids, bi) and np.array_equal(g_d, bd),
          f"topk_budgeted under a deadline that never fires {g_info} "
          "differs from brute force")

    # -- flight recorder ---------------------------------------------------
    counts = prom_counts(engine.render_prom(), "engine_query_latency_ms")
    check(counts == calls, f"render_prom counts {counts} != calls made "
          f"{calls}")
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        n_events = obs.export_trace(str(path))
        with open(path) as f:
            names = {e["name"] for e in json.load(f)["traceEvents"]}
    check({"engine.topk", "engine.radius", "frontdoor.flush",
           "partition.merge"} <= names, f"trace spans {sorted(names)}")

    # -- C1: a COO batch of width 0 on the card ----------------------------
    widths = []
    real = sparse_ops.cabin_build_sparse

    def spy(indices, values, **kw):
        widths.append(indices.shape[1])
        return real(indices, values, **kw)

    small = QueryEngine(params, metric=metric, device=device)
    s_idx, s_val = pubmed_rows(FD_C1_ROWS, gen, device)
    zero = torch.zeros((2, 0), dtype=torch.int32, device=device)
    sparse_ops.cabin_build_sparse = spy
    try:
        small.add_sparse(s_idx, s_val)
        zero_ids = small.add_sparse(zero, zero)
        z_ids, z_d = small.topk((zero[:1], zero[:1]), K)
    finally:
        sparse_ops.cabin_build_sparse = real
    mat, m_alive, alive_ids = small.store.gather_alive()
    bi, bd = brute_topk(torch.zeros((1, mat.shape[1]), dtype=torch.int32,
                                    device=device),
                        mat[:m_alive].contiguous(), alive_ids, metric)
    check(list(zero_ids) == [FD_C1_ROWS, FD_C1_ROWS + 1] and 0 not in widths
          and np.array_equal(z_ids, bi) and np.array_equal(z_d, bd)
          and list(z_ids[0, :2]) == list(zero_ids),
          f"width-0 COO on the card: ids {zero_ids}, widths {widths}, "
          f"topk {z_ids} vs brute force {bi}")

    # -- C2: top-k inputs off 16 bytes -------------------------------------
    c2_q = run["q_sk"][:FD_C2_QUERIES].contiguous()
    c2_b = run["alive"][:FD_C2_ROWS].contiguous()
    for k in (K, topk_ops.MAX_K + 1):
        wv, wi = topk_ops.topk_select_ref(c2_q, c2_b, k, d=SKETCH_DIM,
                                          metric=metric)
        for q, b, what in ((off_16_bytes(c2_q), c2_b, "q"),
                           (c2_q, off_16_bytes(c2_b), "b"),
                           (off_16_bytes(c2_q), off_16_bytes(c2_b), "both")):
            gv, gi = topk_ops.topk_select(q, b, k, d=SKETCH_DIM,
                                          metric=metric)
            torch.cuda.synchronize()
            check(torch.equal(gi, wi) and torch.equal(gv, wv),
                  f"top-k with {what} off 16 bytes at k={k} differs from "
                  "the plain version")

    # -- timings, for the record: on and off in turns -----------------------
    direct = {"obs_on": [], "obs_off": []}
    was = obs.enabled()
    for _ in range(FD_TIMED_CALLS):
        for on in (True, False):
            obs.configure(on)
            b_idx, b_val = pubmed_rows(N_TOPK_QUERIES, gen, device)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engine.topk((b_idx, b_val), K)
            direct["obs_on" if on else "obs_off"].append(
                N_TOPK_QUERIES / (time.perf_counter() - t0))
    obs.configure(was)
    served_qps = (N_TOPK_QUERIES + N_RADIUS_QUERIES) / served_s
    log(f"[frontdoor] {FD_CLIENTS} clients, {n_req} requests of "
        f"{FD_REQ_ROWS} queries ({N_TOPK_QUERIES} topk k={K}, "
        f"{N_RADIUS_QUERIES} radius r={r:.4f}) in {served_s:.3f}s "
        f"({served_qps:.1f} queries/s), {flushes} engine calls; every "
        f"answer equal to the engine's own, {FD_SAMPLE} to brute force; "
        f"kernel launches {launches}; expired deadline: partial, cert_gap "
        f"{info['cert_gap']:.4f}, {int(filled.sum())} of {filled.size} "
        f"slots filled, each at its true distance; a deadline that never "
        f"fires exact; render_prom latency counts {counts} = calls made; "
        f"trace of {n_events} events; C1 width 0 through add_sparse and "
        f"topk (B1 widths {sorted(set(widths))}); C2 off-16-byte q / b / "
        f"both at k = {K} and {topk_ops.MAX_K + 1} bit-identical; direct "
        f"topk queries/s with obs on {direct['obs_on']}, off "
        f"{direct['obs_off']} [{card}]")
    return {"launches": launches, "served_qps": served_qps,
            "direct": direct}


# ---------------------------------------------------------------------------
# clustering over the live index
# ---------------------------------------------------------------------------


def first_argmin(dist: torch.Tensor) -> np.ndarray:
    """Per-row index of the first minimum of a (rows, k) distance matrix,
    as np.argmin gives it."""
    tmin = dist.amin(dim=1, keepdim=True)
    col = torch.arange(dist.shape[1], device=dist.device)
    return torch.where(dist == tmin, col, dist.shape[1]).amin(
        dim=1).cpu().numpy().astype(np.int64)


def brute_assign(rows: torch.Tensor, centers: torch.Tensor, metric: str,
                 d: int = SKETCH_DIM) -> np.ndarray:
    """Nearest centre of each row by the plain versions, first minimum."""
    return first_argmin(plain_dist(rows, centers, metric, d))


def same_cluster_state(a, b) -> bool:
    """Two ClusterIndex objects hold the same labels, counts, weights,
    centres and medoids."""
    return (all(np.array_equal(x, y) for x, y in zip(a.labels(), b.labels()))
            and np.array_equal(a.counts, b.counts)
            and np.array_equal(a.weights, b.weights)
            and np.array_equal(a.centers, b.centers)
            and np.array_equal(a.medoid_ids, b.medoid_ids))


def cluster_phase(run: dict, gen: torch.Generator, rng: np.random.Generator,
                  seed: int, card: str) -> dict:
    """k-medoid clustering attached to the main path's cham engine, as its
    users run it: attach (the full-batch refit), incremental assignment of
    fresh rows, removes, save / restore and refits, held against brute
    force over the plain versions; the k-medoid engine on a sample, on the
    card and on CPU tensors; mini-batch twice.  Returns the phase's launch
    counts and records."""
    metric, engine = "cham", run["engine"]
    device = run["alive"].device
    params = engine.params
    sk_kw = dict(d=SKETCH_DIM, psi_seed=params.psi_seed,
                 pi_seed=params.pi_seed)
    was = obs.enabled()
    obs.configure(True)
    obs.clear_trace()
    phase_t0 = time.perf_counter()
    rec: dict = {"k": CL_K, "n_iter": CL_ITERS}
    build.reset_launches()

    # -- attach: the full-batch refit over the alive rows --------------------
    n0 = len(engine)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ci = engine.cluster(CL_K, seed=seed, n_iter=CL_ITERS)
    torch.cuda.synchronize()
    rec["refit_s"] = time.perf_counter() - t0
    rec["rows"] = n0
    rec["labels_per_s"] = n0 * CL_ITERS / rec["refit_s"]
    mat, n_alive, alive_ids = engine.store.gather_alive()
    alive = mat[:n_alive].contiguous()
    lab_ids, lab = ci.labels()
    centers = torch.from_numpy(ci.centers).to(device)
    check(ci.fitted and np.array_equal(lab_ids, alive_ids),
          "the attached index does not label the alive rows")
    pos = np.searchsorted(alive_ids, ci.medoid_ids)
    check(torch.equal(alive[torch.from_numpy(pos).to(device)], centers),
          "the centres are not the medoids' rows")
    check(np.array_equal(lab, brute_assign(alive, centers, metric)),
          "refit labels differ from a one-shot brute-force assignment "
          "against the medoids")
    weights = engine.store.weights()
    check(np.array_equal(ci.counts, np.bincount(lab, minlength=CL_K))
          and np.array_equal(ci.weights, np.bincount(
              lab, weights=weights, minlength=CL_K).astype(np.int64)),
          "counts / weights differ from the bincounts of the labels")
    rec["counts"] = ci.counts.tolist()

    # -- incremental assignment: fresh rows through the engine ---------------
    f_idx, f_val = pubmed_rows(CL_FRESH, gen, device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    new_ids, new_lab = ci.add_sparse(f_idx, f_val)
    torch.cuda.synchronize()
    rec["add_sparse_rows_per_s"] = CL_FRESH / (time.perf_counter() - t0)
    f_sk = sparse_ops.cabin_build_sparse_ref(f_idx, f_val, **sk_kw)
    check(np.array_equal(new_lab, brute_assign(f_sk, centers, metric)),
          "incremental labels differ from brute force")
    check(np.array_equal(ci.counts, np.bincount(ci.labels()[1],
                                                minlength=CL_K)),
          "counts after the incremental adds differ from the bincount")
    # the assignment path alone, on other fresh rows (not in any cache)
    a_idx, a_val = pubmed_rows(CL_FRESH, gen, device)
    a_sk = sparse_ops.cabin_build_sparse(a_idx, a_val, **sk_kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    a_lab = ci.assign_packed(a_sk)
    rec["assign_rows_per_s"] = CL_FRESH / (time.perf_counter() - t0)
    check(np.array_equal(a_lab, brute_assign(a_sk, centers, metric)),
          "assign_packed differs from brute force")

    # -- remove 1%: the counts follow ----------------------------------------
    kill = rng.choice(engine.ids(), len(engine) // 100, replace=False)
    before = ci.counts
    gone = np.bincount(ci.label_of(kill), minlength=CL_K)
    engine.remove(kill)
    check(np.array_equal(ci.counts, before - gone)
          and np.array_equal(ci.counts, np.bincount(ci.labels()[1],
                                                    minlength=CL_K))
          and ci.counts.sum() == len(engine),
          "counts after removing 1% do not follow")

    # -- save / restore, then a refit of each --------------------------------
    with tempfile.TemporaryDirectory() as snap:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ci.save(snap)
        rec["save_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = ClusterIndex.restore(snap, device=device)
        torch.cuda.synchronize()
        rec["restore_s"] = time.perf_counter() - t0
    check(same_cluster_state(back, ci)
          and np.array_equal(back.engine.ids(), engine.ids())
          and back.mutations_since_refit == ci.mutations_since_refit,
          "the restored cluster index holds another state")
    mat_b, nb, _ = back.engine.store.gather_alive()
    mat_a, na, _ = engine.store.gather_alive()
    check(na == nb and torch.equal(mat_a[:na], mat_b[:nb]),
          "the restored engine holds other rows")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ci.refit(n_iter=CL_REFIT_ITERS)
    torch.cuda.synchronize()
    rec["second_refit_s"] = time.perf_counter() - t0
    back.refit(n_iter=CL_REFIT_ITERS)
    check(same_cluster_state(back, ci),
          "a refit of the restored index differs from the original's")
    back.detach()
    del back

    # -- the k-medoid engine on a sample: card against CPU tensors -----------
    mat, n_alive, _ = engine.store.gather_alive()
    pick = torch.from_numpy(np.sort(rng.choice(
        n_alive, CL_SAMPLE, replace=False))).to(device)
    sample = mat.index_select(0, pick).contiguous()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    on_card = kmode_packed(sample, CL_K, d=SKETCH_DIM, n_iter=CL_SAMPLE_ITERS,
                           seed=seed, metric=metric, device=device)
    torch.cuda.synchronize()
    rec["sample_card_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    on_cpu = kmode_packed(sample.cpu(), CL_K, d=SKETCH_DIM,
                          n_iter=CL_SAMPLE_ITERS, seed=seed, metric=metric,
                          device="cpu")
    rec["sample_cpu_s"] = time.perf_counter() - t0
    check(np.array_equal(on_card.labels, on_cpu.labels)
          and np.array_equal(on_card.medoids, on_cpu.medoids)
          and np.array_equal(on_card.centers, on_cpu.centers),
          "kmode_packed on the card differs from the CPU plain run")

    # -- mini-batch, twice: deterministic ------------------------------------
    mb_rows = mat[:min(CL_MB_ROWS, n_alive)].contiguous()
    runs, mb_s = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs.append(kmode_packed(mb_rows, CL_K, d=SKETCH_DIM,
                                 n_iter=CL_MB_ITERS, seed=seed, metric=metric,
                                 batch_rows=CL_BATCH_ROWS, device=device))
        torch.cuda.synchronize()
        mb_s.append(time.perf_counter() - t0)
    check(np.array_equal(runs[0].labels, runs[1].labels)
          and np.array_equal(runs[0].centers, runs[1].centers),
          "mini-batch kmode_packed is not deterministic")
    check(np.array_equal(runs[0].labels, brute_assign(
        mb_rows, torch.from_numpy(runs[0].centers).to(device), metric)),
          "mini-batch labels are not an assignment against its centres")
    rec["minibatch"] = {"rows": mb_rows.shape[0], "n_iter": CL_MB_ITERS,
                        "batch_rows": CL_BATCH_ROWS, "s": mb_s,
                        "labels_per_s": [mb_rows.shape[0] * CL_MB_ITERS / s
                                         for s in mb_s]}
    launches = dict(build.LAUNCHES)
    for kernel in ("topk_select", "pair_stats", "row_popcount"):
        check(launches[kernel] > 0,
              f"kernel {kernel} was not launched in the cluster phase")

    # -- its instruments keep the reference's names --------------------------
    prom = engine.render_prom()
    check(prom_counts(prom, "engine_query_latency_ms").get("assign", 0) >= 2
          and re.search(rf"^cluster_refits_total {ci.n_refits}$", prom,
                        re.M) is not None,
          "the cluster instruments are missing from render_prom")
    names = {e["name"] for e in obs.trace_events()}
    check({"cluster.refit", "cluster.assign"} <= names,
          f"cluster spans missing from the trace: {sorted(names)}")
    ci.detach()
    obs.configure(was)
    rec["phase_s"] = time.perf_counter() - phase_t0
    log(f"[cluster] {rec['phase_s']:.1f}s in all; k={CL_K} over {n0} rows: attach (full-batch refit, "
        f"n_iter {CL_ITERS}) {rec['refit_s']:.3f}s ({rec['labels_per_s']:.1f}"
        f" labels/s), counts {rec['counts']}; {CL_FRESH} fresh rows "
        f"through add_sparse {rec['add_sparse_rows_per_s']:.1f} rows/s, "
        f"assign_packed {rec['assign_rows_per_s']:.1f} rows/s, each label "
        f"equal to brute force; 1% removed, counts follow; save "
        f"{rec['save_s']:.3f}s, restore {rec['restore_s']:.3f}s, refits "
        f"(n_iter {CL_REFIT_ITERS}) of both equal ({rec['second_refit_s']:.3f}"
        f"s); kmode_packed on {CL_SAMPLE} rows (n_iter {CL_SAMPLE_ITERS}): card "
        f"{rec['sample_card_s']:.3f}s, CPU {rec['sample_cpu_s']:.3f}s, "
        f"equal; mini-batch ({CL_BATCH_ROWS}-row slices, n_iter "
        f"{CL_MB_ITERS}) over {mb_rows.shape[0]} rows twice, equal: "
        f"{rec['minibatch']['labels_per_s']} labels/s; kernel launches "
        f"{launches} [{card}]")
    return {"launches": launches, "record": rec}


# ---------------------------------------------------------------------------
# the index's lifecycle: merge, shard, migrate with a journal, save/restore
# ---------------------------------------------------------------------------


def lifecycle_queries(gen: torch.Generator, device) -> tuple:
    """A fresh batch of N_TOPK_QUERIES topk and N_RADIUS_QUERIES radius
    COO queries (fresh, so that no answer comes from a result cache)."""
    return (pubmed_rows(N_TOPK_QUERIES, gen, device),
            pubmed_rows(N_RADIUS_QUERIES, gen, device))


def engine_answers(engine, batch, r: float) -> tuple:
    (q_idx, q_val), rq = batch
    ids, dist = engine.topk((q_idx, q_val), K)
    return ids, dist, engine.radius(rq, r)


def same_answers(a: tuple, b: tuple) -> bool:
    return (np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
            and len(a[2]) == len(b[2])
            and all(np.array_equal(x, y) for x, y in zip(a[2], b[2])))


def tier_brute_force(tiers: list, batch, r: float, metric: str) -> tuple:
    """topk and radius answers over stores scanned whole by the plain
    versions, each in its own sketch space: `tiers` holds (store, params);
    the topk candidates of every tier merge by (value, id)."""
    (q_idx, q_val), (rq_idx, rq_val) = batch
    cand_d, cand_i, hits = [], [], [[] for _ in range(rq_idx.shape[0])]
    for store, params in tiers:
        mat, n, ids = store.gather_alive()
        if n == 0:
            continue
        rows = mat[:n].contiguous()
        kw = dict(d=params.sketch_dim, psi_seed=params.psi_seed,
                  pi_seed=params.pi_seed)
        q_sk = sparse_ops.cabin_build_sparse_ref(q_idx, q_val, **kw)
        bi, bd = brute_topk(q_sk, rows, ids, metric, k=min(K, n),
                            d=params.sketch_dim)
        cand_i.append(bi)
        cand_d.append(bd)
        rq_sk = sparse_ops.cabin_build_sparse_ref(rq_idx, rq_val, **kw)
        dist = plain_dist(rq_sk, rows, metric, d=params.sketch_dim)
        hit = (dist < torch.tensor(r, dtype=torch.float32)).cpu().numpy()
        for qi in range(len(hits)):
            hits[qi].append(ids[np.flatnonzero(hit[qi])])
    ci, cd = np.concatenate(cand_i, 1), np.concatenate(cand_d, 1)
    order = np.lexsort((ci, cd), axis=1)[:, :K]
    return (np.take_along_axis(ci, order, 1), np.take_along_axis(cd, order, 1),
            [np.sort(np.concatenate(h)) for h in hits])


def ingest(engine, idx: torch.Tensor, val: torch.Tensor) -> float:
    """add_sparse of the rows in chunks of CHUNK; returns the seconds."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r0 in range(0, idx.shape[0], CHUNK):
        engine.add_sparse(idx[r0:r0 + CHUNK], val[r0:r0 + CHUNK])
    torch.cuda.synchronize()
    return time.perf_counter() - t0


@contextlib.contextmanager
def timed_saves(engine, saves: list):
    """Appends the seconds of each `engine.save` made inside the block to
    `saves`; the engine's own save is back in place however it ends."""
    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        type(engine).save(engine, *args, **kwargs)
        saves.append(time.perf_counter() - t0)

    engine.save = timed
    try:
        yield
    finally:
        del engine.save


def lifecycle_phase(idx: torch.Tensor, val: torch.Tensor,
                    gen: torch.Generator, rng: np.random.Generator,
                    card: str) -> dict:
    """The cham engine's configuration through the index's lifecycle, as
    its users run it: two engines built apart and merged, the merged
    engine sharded, migrated under drift to a wider sketch with a journal
    (restored mid-flight from it), then saved and restored.  Every answer
    is held against brute force or against an engine that must answer the
    same, bit for bit.  Returns the phase's launch counts and records, and
    the migrated store and queries for the kernel phase."""
    metric, device = "cham", idx.device
    params = CabinParams.create(N_DIMS, SKETCH_DIM, seed=0)
    was = obs.enabled()
    obs.configure(True)
    rec: dict = {}
    half = N_ROWS // 2
    build.reset_launches()

    # -- merge: A holds rows [0, half), B rows [half, N_ROWS) ---------------
    a = QueryEngine(params, metric=metric, device=device)
    b = QueryEngine(params, metric=metric, device=device)
    b.store._next_id = half  # the merge tree's id offset of its workers
    rec["ingest_rows_per_s"] = N_ROWS / (ingest(a, idx[:half], val[:half])
                                         + ingest(b, idx[half:], val[half:]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    a.merge(b)
    torch.cuda.synchronize()
    rec["merge_s"] = time.perf_counter() - t0
    del b
    check(a.obs_snapshot()["store_merges_total"] == 1,
          "store_merges_total after one merge")
    seq = QueryEngine(params, metric=metric, device=device, keep_raw=False)
    ingest(seq, idx, val)
    size = seq.store.size
    check(a.store.size == size
          and torch.equal(a.store.sk_buf[:size], seq.store.sk_buf[:size])
          and np.array_equal(a.store.ids_at(np.arange(size)),
                             seq.store.ids_at(np.arange(size)))
          and np.array_equal(a.store.weights_at(np.arange(size)),
                             seq.store.weights_at(np.arange(size))),
          "the merged store's packed rows, ids and weights differ from a "
          "sequential build's")
    del seq
    batch = lifecycle_queries(gen, device)
    (q_idx, q_val), _ = batch
    first = a.topk((q_idx[:N_RADIUS_QUERIES], q_val[:N_RADIUS_QUERIES]), K)
    r = float(np.median(first[1][:, K - 1]))
    tiers = [(a.store, params)]
    check(same_answers(engine_answers(a, batch, r),
                       tier_brute_force(tiers, batch, r, metric)),
          "merged engine's topk / radius differ from brute force")

    # -- shard into 4 partition groups --------------------------------------
    batch = lifecycle_queries(gen, device)
    unsharded = engine_answers(a, batch, r)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    a.shard(n_shards=LC_SHARDS)
    a.sync_layout()
    torch.cuda.synchronize()
    rec["shard_rebuild_s"] = time.perf_counter() - t0
    snap = a.obs_snapshot()
    shards = {lab.split("shard=")[1] for lab in snap["partition_rows"]
              if "role=serve" in lab}
    check(a.stats()["n_shards"] == LC_SHARDS and snap["engine_shards"]
          == LC_SHARDS and shards == {str(s) for s in range(LC_SHARDS)},
          f"shard(): n_shards {a.stats()['n_shards']}, partition_rows "
          f"shards {sorted(shards)}")
    sharded = engine_answers(a, batch, r)
    check(same_answers(sharded, unsharded),
          "sharded answers differ from the unsharded engine's")
    check(same_answers(sharded, tier_brute_force(tiers, batch, r, metric)),
          "sharded answers differ from brute force")
    # the ids the engine acknowledged, from the phase's own bookkeeping:
    # the merge tree's ids, then each add takes the next CHUNK
    acked = np.arange(N_ROWS + CHUNK)
    add1 = pubmed_rows(CHUNK, gen, device)
    check(np.array_equal(a.add_sparse(*add1), acked[N_ROWS:])
          and np.array_equal(np.sort(a.ids()), acked),
          "the sharded engine's ids differ from the ids it acknowledged")
    kill = rng.choice(acked, len(acked) // 100, replace=False)
    a.remove(kill)
    batch = lifecycle_queries(gen, device)
    check(same_answers(engine_answers(a, batch, r),
                       tier_brute_force(tiers, batch, r, metric)),
          "sharded answers after add and remove differ from brute force")

    # -- migrate under drift, journaled ---------------------------------------
    nnz = torch.cat([(val != 0).sum(1), (add1[1] != 0).sum(1)]).cpu().numpy()
    p95 = int(np.ceil(np.percentile(nnz, 95)))
    d_new = theory.sketch_dim(p95)
    saves: list[float] = []  # seconds of each of A's journal saves

    with tempfile.TemporaryDirectory() as journal, \
            tempfile.TemporaryDirectory() as snapdir:
        with timed_saves(a, saves):  # the migration journals through save
            t0 = time.perf_counter()
            mig = a.migrate(d=d_new, batch_rows=CHUNK, drive="manual",
                            journal_dir=journal,
                            journal_every=LC_JOURNAL_EVERY)
            start_s = time.perf_counter() - t0
            n_batches = -(-len(mig.src) // CHUNK)
            half_batches = max(LC_JOURNAL_EVERY, n_batches // 2
                               // LC_JOURNAL_EVERY * LC_JOURNAL_EVERY)
            step_s = 0.0
            for _ in range(half_batches - 1):
                t0 = time.perf_counter()
                a.migration_step()
                step_s += time.perf_counter() - t0
            add2 = pubmed_rows(CHUNK, gen, device)
            fresh_ids = a.add_sparse(*add2)
            t0 = time.perf_counter()
            a.migration_step()  # a journal boundary: fresh rows are in it
            step_s += time.perf_counter() - t0
            check(np.array_equal(fresh_ids, np.arange(len(acked),
                                                      len(acked) + CHUNK))
                  and len(mig.fresh) == CHUNK
                  and mig.fresh.contains(int(fresh_ids[0]))
                  and mig.n_batches % LC_JOURNAL_EVERY == 0,
                  "mid-migration adds did not land in the fresh tier")
            acked = np.concatenate([acked, fresh_ids])
            new_params = mig.new_spec.params
            mig_tiers = [(mig.src, params), (mig.dst, new_params),
                         (mig.fresh, new_params)]
            # membership from the phase's bookkeeping, not from the tiers:
            # each acknowledged row not removed is served by one tier
            held = [store.gather_alive() for store, _ in mig_tiers]
            held = np.concatenate([g.ids[:g.n_alive] for g in held])
            check(len(held) == len(np.unique(held)) and np.array_equal(
                np.sort(held), np.setdiff1d(acked, kill)),
                "mid-migration tiers overlap, or their union is not the "
                "acknowledged rows less the removed ones")
            batch = lifecycle_queries(gen, device)
            mid = engine_answers(a, batch, r)
            check(same_answers(mid, tier_brute_force(mig_tiers, batch, r,
                                                     metric)),
                  "mid-migration topk / radius differ from the per-tier "
                  "brute force")
            try:
                a.pairwise(batch[1], None)
                check(False, "pairwise answered mid-migration")
            except RuntimeError:
                pass
            progress = a.obs_snapshot()["engine_migration_progress"]
            check(0.0 < progress < 1.0,
                  f"engine_migration_progress {progress}")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            twin = QueryEngine.restore(journal, device=device)
            torch.cuda.synchronize()
            journal_restore_s = time.perf_counter() - t0
            check(twin.migrating and twin.migration.cursor == mig.cursor,
                  "the journal did not restore the migration in flight")
            batch = lifecycle_queries(gen, device)
            check(same_answers(engine_answers(twin, batch, r),
                               engine_answers(a, batch, r)),
                  "the engine restored from the journal answers differently")
            rows_left = len(mig.src)
            t0 = time.perf_counter()
            a.migrate_all()
            torch.cuda.synchronize()
            step_s += time.perf_counter() - t0
        # the twin resumes the journal in the directory it was restored
        # from, as a restarted process does; A is done with it
        twin.migrate_all()
        rec["migration_rows_per_s"] = mig.rows_migrated / step_s
        rec["migration_rows_per_s_without_journal"] = (
            mig.rows_migrated / (step_s - sum(saves[1:])))
        rec["migration"] = {
            "d_from": SKETCH_DIM, "d_to": d_new, "p95_nnz": p95,
            "batches": mig.n_batches, "rows": mig.rows_migrated,
            "start_s": start_s, "resketch_and_fold_s": step_s,
            "journal_saves_s": saves,
            "rows_after_journal_restore": rows_left,
            "journal_restore_s": journal_restore_s}
        check(not a.migrating and not twin.migrating and a.d == d_new,
              "migrate_all left a migration in flight")

        # a fresh build at the new spec from the same alive rows
        fresh = QueryEngine(new_params, metric=metric, device=device,
                            keep_raw=False)
        ingest(fresh, torch.cat([idx, add1[0], add2[0]]),
               torch.cat([val, add1[1], add2[1]]))
        fresh.remove(kill)
        want = fresh.store.gather_alive()
        for who, eng in (("the migrated engine", a), ("its twin", twin)):
            got = eng.store.gather_alive()
            check(got.n_alive == want.n_alive
                  and np.array_equal(got.ids, want.ids)
                  and torch.equal(got.matrix[:got.n_alive],
                                  want.matrix[:want.n_alive]),
                  f"{who} does not hold a fresh build's packed bits")
        batch = lifecycle_queries(gen, device)
        want_ans = tier_brute_force([(fresh.store, new_params)], batch, r,
                                    metric)
        check(same_answers(engine_answers(fresh, batch, r), want_ans)
              and same_answers(engine_answers(a, batch, r), want_ans)
              and same_answers(engine_answers(twin, batch, r), want_ans),
              "migrated answers differ from the fresh build's / brute force")
        del fresh

        # -- save and restore -----------------------------------------------
        for part in ("store", "raw"):
            t0 = time.perf_counter()
            getattr(a, part).state_tree()
            rec[f"{part}_state_tree_s"] = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a.save(snapdir)
        rec["save_s"] = time.perf_counter() - t0
        rec["snapshot_mb"] = sum(
            f.stat().st_size for f in Path(snapdir).rglob("*")
            if f.is_file()) / 2**20
        t0 = time.perf_counter()
        restored = QueryEngine.restore(snapdir, device=device)
        torch.cuda.synchronize()
        rec["restore_s"] = time.perf_counter() - t0
    batch = lifecycle_queries(gen, device)
    check(same_answers(engine_answers(restored, batch, r),
                       engine_answers(a, batch, r)),
          "the restored engine answers differently")
    launches = dict(build.LAUNCHES)
    for kernel in ("cabin_build_sparse", "topk_select", "pair_stats",
                   "row_popcount"):
        check(launches[kernel] > 0,
              f"kernel {kernel} was not launched in the lifecycle phase")

    # -- for the record: topk queries/s, unsharded against 4 shards ----------
    qps = {"unsharded": [], "sharded": []}
    restored.sync_layout()
    for _ in range(TIMED_RUNS):
        q_idx, q_val = pubmed_rows(N_TOPK_QUERIES, gen, device)
        answers = []
        for name, eng in (("unsharded", restored), ("sharded", a)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            answers.append(eng.topk((q_idx, q_val), K))
            qps[name].append(N_TOPK_QUERIES / (time.perf_counter() - t0))
        check(all(np.array_equal(x, y) for x, y in zip(*answers)),
              "sharded and unsharded topk differ")
    rec["topk_qps"] = qps
    obs.configure(was)
    mat, n_alive, _ = a.store.gather_alive()
    kw = dict(d=d_new, psi_seed=new_params.psi_seed,
              pi_seed=new_params.pi_seed)
    q_sk = sparse_ops.cabin_build_sparse_ref(q_idx, q_val, **kw)
    log(f"[lifecycle] ingest into two engines "
        f"{rec['ingest_rows_per_s']:.1f} rows/s; merge "
        f"{rec['merge_s']:.3f}s (store bits = a sequential build's); "
        f"shard({LC_SHARDS}) rebuild {rec['shard_rebuild_s']:.3f}s; "
        f"migration d {SKETCH_DIM} -> {d_new} (p95 nnz {p95}) "
        f"{rec['migration']} at {rec['migration_rows_per_s']:.1f} rows/s "
        f"({rec['migration_rows_per_s_without_journal']:.1f} without the "
        f"journal's saves); "
        f"save {rec['save_s']:.3f}s, restore {rec['restore_s']:.3f}s, "
        f"snapshot {rec['snapshot_mb']:.1f} MB; topk queries/s unsharded "
        f"{qps['unsharded']}, {LC_SHARDS} shards {qps['sharded']}; kernel "
        f"launches {launches}; every answer equal to brute force or its "
        f"twin [{card}]")
    return {"launches": launches, "record": rec, "d": d_new, "kw": kw,
            "alive": mat[:n_alive].contiguous(), "q_sk": q_sk}


# ---------------------------------------------------------------------------
# the corpus: documents, bulk ingest, dedup and the batch pipeline
# ---------------------------------------------------------------------------


def store_arrays(engine) -> dict:
    """The store's and the raw archive's snapshot arrays."""
    out = {f"store/{k}": v for k, v in engine.store.state_tree().items()}
    if engine.raw is not None:
        out.update({f"raw/{k}": v for k, v in engine.raw.state_tree().items()})
    return out


def same_arrays(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]) for k in a)


def same_dedup(a, b) -> bool:
    return (np.array_equal(a.keep_mask, b.keep_mask)
            and np.array_equal(a.group_ids, b.group_ids)
            and a.n_groups == b.n_groups and a.n_removed == b.n_removed)


def counted(fn):
    """fn() with the launch counts set to 0 just before; (result, counts)."""
    build.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(build.LAUNCHES)


def corpus_phase(seed: int, card: str, device) -> dict:
    """A corpus of token documents at llama3-8B's vocabulary through the
    port's data path: the sequential and the bulk (merge-tree) ingest,
    ingest with in-window dedup on the card and on the CPU, corpus dedup
    four ways, the LM batch pipeline with dedup on the card and on the
    CPU, and topk over the kept documents, each held against its twin or
    brute force.  Returns the phase's launch counts, records and the
    inputs of the corpus-width kernel checks."""
    rec: dict = {}
    phase_t0 = t0 = time.perf_counter()
    docs = list(itertools.islice(synthetic_documents(
        CORPUS_VOCAB, seed, mean_len=CORPUS_MEAN_LEN,
        dup_fraction=CORPUS_DUP), CORPUS_DOCS))
    rec["generate_s"] = time.perf_counter() - t0
    distinct = np.array([len(np.unique(doc)) for doc in docs])
    p95 = int(np.ceil(np.percentile(distinct, 95)))
    d = theory.sketch_dim(p95)
    w = packing.packed_width(d)
    params = CabinParams.create(CORPUS_VOCAB, d, seed=seed)
    rec.update(docs=CORPUS_DOCS, p95_distinct=p95, d=d, w=w,
               tokens=int(sum(len(doc) for doc in docs)))
    shards = [list(s) for s in np.array_split(
        np.arange(CORPUS_DOCS), CORPUS_SHARDS)]
    shards = [[docs[i] for i in s] for s in shards]
    n_windows = -(-CORPUS_DOCS // CORPUS_WINDOW)
    total = dict.fromkeys(build.LAUNCHES, 0)

    def add(counts):
        for name, n in counts.items():
            total[name] += n

    # -- bulk ingest over 4 shards against the sequential ingest -------------
    engines = {}
    for metric in ("cham", "hamming"):
        seq = QueryEngine(params, metric=metric, device=device)
        t0 = time.perf_counter()
        ids_seq, seq_n = counted(lambda: ingest_documents(
            seq, docs, window=CORPUS_WINDOW))
        seq_s = time.perf_counter() - t0
        par = QueryEngine(params, metric=metric, device=device)
        t0 = time.perf_counter()
        ids_par, par_n = counted(lambda: bulk_ingest(
            par, shards, workers=CORPUS_SHARDS, window=CORPUS_WINDOW))
        par_s = time.perf_counter() - t0
        add(seq_n)
        add(par_n)
        check(np.array_equal(ids_seq, np.arange(CORPUS_DOCS))
              and np.array_equal(ids_par, ids_seq),
              f"{metric}: bulk ingest ids differ from the sequential's")
        check(same_arrays(store_arrays(par), store_arrays(seq)),
              f"{metric}: bulk ingest's store or archive differs from the "
              "sequential build's")
        # every launch counted: one B1 and one B4 a window either way, and
        # one B4 a store merge (three in the tree, one into the target)
        check(seq_n["cabin_build_sparse"] == n_windows
              == par_n["cabin_build_sparse"]
              and seq_n["row_popcount"] == n_windows
              and par_n["row_popcount"] == n_windows + CORPUS_SHARDS,
              f"{metric}: launch counts sequential {seq_n}, bulk {par_n} "
              f"for {n_windows} windows")
        rec[f"{metric}_docs_per_s"] = {"sequential": CORPUS_DOCS / seq_s,
                                       "bulk": CORPUS_DOCS / par_s}
        engines[metric] = par
    # the same bulk load with one worker thread: the cost of the threads
    one = QueryEngine(params, device=device)
    t0 = time.perf_counter()
    ids_one, n = counted(lambda: bulk_ingest(one, shards, workers=1,
                                             window=CORPUS_WINDOW))
    rec["cham_docs_per_s"]["bulk_one_worker"] = (
        CORPUS_DOCS / (time.perf_counter() - t0))
    add(n)
    check(np.array_equal(ids_one, np.arange(CORPUS_DOCS))
          and same_arrays(store_arrays(one), store_arrays(engines["cham"])),
          "bulk ingest with one worker differs")
    del one

    # -- ingest with in-window dedup: the card against the CPU ---------------
    gd = QueryEngine(params, device=device)
    t0 = time.perf_counter()
    ids_gd, n = counted(lambda: ingest_documents(
        gd, docs, window=CORPUS_WINDOW, dedup_threshold=CORPUS_THRESHOLD))
    rec["dedup_ingest_docs_per_s"] = CORPUS_DOCS / (time.perf_counter() - t0)
    add(n)
    cd = QueryEngine(params, device="cpu")
    t0 = time.perf_counter()
    ids_cd = ingest_documents(cd, docs, window=CORPUS_WINDOW,
                              dedup_threshold=CORPUS_THRESHOLD)
    rec["dedup_ingest_cpu_s"] = time.perf_counter() - t0
    kept = ids_gd >= 0
    check(np.array_equal(ids_gd, ids_cd)
          and same_arrays(store_arrays(gd), store_arrays(cd)),
          "ingest with dedup on the card differs from the CPU's")
    rec["dedup_ingest_kept"] = int(kept.sum())

    # -- corpus dedup: banded, tiled, blocked and brute force ----------------
    sk = engines["cham"].store.gather_alive()[0][:CORPUS_DOCS].contiguous()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    banded, n = counted(lambda: dedup_by_sketch(
        sk, d, CORPUS_THRESHOLD, device=device))
    rec["dedup_s"] = time.perf_counter() - t0
    add(n)
    weights = hamming_ops.row_popcount_ref(sk).cpu().numpy()
    order = np.argsort(weights, kind="stable")
    sorted_sk = sk[torch.from_numpy(order).to(device)].contiguous()
    t0 = time.perf_counter()
    pairs = allpairs.threshold_pairs(sorted_sk, d=d,
                                     threshold=CORPUS_THRESHOLD)
    rec["tiled_scan_s"] = time.perf_counter() - t0
    tiled = dedup_mod._result_from_roots(dedup_mod._components_from_pairs(
        CORPUS_DOCS, order[pairs] if len(pairs) else pairs), CORPUS_DOCS)
    t0 = time.perf_counter()
    blocked = dedup_by_sketch_blocked(sk, d, CORPUS_THRESHOLD, device=device)
    rec["blocked_s"] = time.perf_counter() - t0
    hit = []
    thr = torch.tensor(CORPUS_THRESHOLD, dtype=torch.float32, device=device)
    for i0 in range(0, CORPUS_DOCS, 2048):
        dist = plain_dist(sk[i0:i0 + 2048], sk, "cham", d)
        r, c = torch.nonzero(dist < thr, as_tuple=True)
        keep = i0 + r < c
        hit.append(torch.stack([i0 + r[keep], c[keep]], 1).cpu().numpy())
    brute_pairs = np.concatenate(hit)
    brute = dedup_mod._result_from_roots(dedup_mod._components_from_pairs(
        CORPUS_DOCS, brute_pairs), CORPUS_DOCS)
    check(same_dedup(banded, tiled) and same_dedup(banded, blocked)
          and same_dedup(banded, brute),
          "corpus dedup: banded, tiled, blocked and brute force differ")
    check({(min(i, j), max(i, j)) for i, j in order[pairs].tolist()}
          == {(i, j) for i, j in brute_pairs.tolist()}
          and len(pairs) == len(brute_pairs),
          "the tiled scan's pairs differ from brute force")
    rec.update(dedup_pairs=len(brute_pairs), dedup_groups=banded.n_groups,
               dedup_removed=banded.n_removed)

    # -- the LM batch pipeline with dedup: the card against the CPU ----------
    cfg = PipelineConfig(vocab_size=CORPUS_VOCAB, seq_len=PIPE_SEQ,
                         global_batch=PIPE_BATCH, seed=seed, dedup=True)
    batches = {}
    for where, dev in (("card", device), ("cpu", "cpu")):
        t0 = time.perf_counter()
        pipe = BatchPipeline(cfg, device=dev)
        batches[where] = [next(pipe) for _ in range(PIPE_BATCHES)]
        rec[f"pipeline_{where}_batches_per_s"] = (
            PIPE_BATCHES / (time.perf_counter() - t0))
        pipe.close()
        pipe._thread.join(timeout=120)
        check(not pipe._thread.is_alive(), "the pipeline's prefetch thread "
              "did not stop")
    check(all(np.array_equal(a[key], b[key])
              for a, b in zip(batches["card"], batches["cpu"]) for key in a)
          and batches["cpu"][0]["tokens"].shape == (PIPE_BATCH, PIPE_SEQ),
          "the pipeline's batches on the card differ from the CPU's")

    # -- topk over the kept documents, against brute force -------------------
    qdocs = [doc for doc, k in zip(docs, kept) if k][:CORPUS_QUERIES]
    q_idx, q_val = dedup_mod.docs_to_categorical(qdocs, CORPUS_VOCAB)
    (nn_ids, nn_d), n = counted(lambda: gd.topk((q_idx, q_val), K))
    add(n)
    mat, m_alive, alive_ids = gd.store.gather_alive()
    q_sk = sparse_ops.cabin_build_sparse_ref(
        torch.from_numpy(q_idx).to(device), torch.from_numpy(q_val).to(device),
        d=d, psi_seed=params.psi_seed, pi_seed=params.pi_seed)
    bi, bd = brute_topk(q_sk, mat[:m_alive].contiguous(), alive_ids, "cham",
                        d=d)
    check(np.array_equal(nn_ids, bi) and np.array_equal(nn_d, bd),
          "topk over the kept documents differs from brute force")
    for kernel in ("cabin_build_sparse", "topk_select", "pair_stats",
                   "row_popcount"):
        check(total[kernel] > 0,
              f"kernel {kernel} was not launched in the corpus phase")

    # the corpus-width kernel inputs: a window, the bulk engine's rows and
    # the kept documents' sketches, one banded strip of the corpus dedup
    w_idx, w_val = dedup_mod.docs_to_categorical(docs[:CORPUS_WINDOW],
                                                 CORPUS_VOCAB)
    strip = dedup_strip(sorted_sk, weights[order], d)
    bulk_mat, bulk_n, _ = engines["cham"].store.gather_alive()
    rec["phase_s"] = time.perf_counter() - phase_t0
    log(f"[corpus] {rec['phase_s']:.1f}s in all; {CORPUS_DOCS} documents (vocab {CORPUS_VOCAB}, mean "
        f"length {CORPUS_MEAN_LEN}, dup_fraction {CORPUS_DUP}, "
        f"{rec['tokens']} tokens) made in {rec['generate_s']:.1f}s; p95 "
        f"distinct tokens {p95}: d = {d}, W = {w}; ingest documents/s "
        f"(sequential, bulk over {CORPUS_SHARDS} shards): cham "
        f"{rec['cham_docs_per_s']}, hamming {rec['hamming_docs_per_s']}, "
        f"bulk equal to sequential (store, archive, ids, launches); ingest "
        f"with dedup < {CORPUS_THRESHOLD} "
        f"{rec['dedup_ingest_docs_per_s']:.1f} docs/s, {int(kept.sum())} "
        f"kept, equal to the CPU's ({rec['dedup_ingest_cpu_s']:.1f}s); "
        f"corpus dedup {rec['dedup_s']:.3f}s ({len(brute_pairs)} pairs, "
        f"{banded.n_removed} removed), equal to the tiled scan "
        f"({rec['tiled_scan_s']:.3f}s), the blocked scan "
        f"({rec['blocked_s']:.3f}s) and brute force; pipeline batches/s "
        f"card {rec['pipeline_card_batches_per_s']:.2f}, CPU "
        f"{rec['pipeline_cpu_batches_per_s']:.2f}, equal; topk over "
        f"{len(qdocs)} kept documents equal to brute force; kernel "
        f"launches {total} [{card}]")
    return {"launches": total, "record": rec, "d": d, "params": params,
            "window": (torch.from_numpy(w_idx).to(device),
                       torch.from_numpy(w_val).to(device)),
            "alive": bulk_mat[:bulk_n].contiguous(), "q_sk": q_sk,
            "strip": strip}


def dedup_strip(sorted_sk: torch.Tensor, weights: np.ndarray, d: int):
    """The (block, width) strip of the corpus dedup's banded scan whose
    width is largest: (row block, strip rows) as threshold_pairs takes
    them."""
    scores = allpairs.prune_score_host(weights, d, "cham")
    n, block = sorted_sk.shape[0], 256
    width = allpairs._band_width(scores, n, block, CORPUS_THRESHOLD,
                                 allpairs.prune_factor("cham"))
    return (sorted_sk[:block].contiguous(),
            sorted_sk[:min(width, n)].contiguous())


# ---------------------------------------------------------------------------
# LM serving
# ---------------------------------------------------------------------------


def record_attention(call, n_layers: int, fault=None):
    """Runs call() and returns its result and, for every attention call of
    the run, clones of its (q, k, v), causal flag and output.  With
    `fault`, the layers in fault[0] get the attention fault[1] in place of
    the real one (a planted fault)."""
    seen = []
    real = flash_ops.attention

    def spy(q, k, v, *, causal=True, impl=None):
        if fault is not None and len(seen) % n_layers in fault[0]:
            out = fault[1](q, k, v, causal=causal)
        else:
            out = real(q, k, v, causal=causal, impl=impl)
        seen.append((q.clone(), k.clone(), v.clone(), causal, out.clone()))
        return out

    flash_ops.attention = spy
    try:
        result = call()
    finally:
        flash_ops.attention = real
    check(len(seen) == n_layers, f"{len(seen)} attention calls, expected "
          f"one per layer ({n_layers})")
    return result, seen


def layer_ratios(seen) -> list[float]:
    """Each layer's attention output against the plain attention on the
    same inputs, as max |diff| / the B6 tolerance (at most 1 holds)."""
    return [flash_ops.tolerance_ratio(
        out, flash_ops.attention_ref(q, k, v, causal=causal))
        for q, k, v, causal, out in seen]


def compare_lm(got, plain) -> dict:
    """The end-to-end rule holding one LM run against the plain path's run:
    prefill logits within LOGIT_TOL; the logits each token was chosen from
    within LOGIT_TOL wherever both runs had the same tokens before it (up to
    and including the first differing one); greedy tokens equal up to the
    first step where the plain run's top-1 / top-2 margin is under
    LOGIT_TOL.  Returns the readings and whether the rule holds."""
    diff = float((got.prefill_logits - plain.prefill_logits).abs().max())
    n_req, n_new = plain.tokens.shape
    same_history, step_diff = 0, 0.0
    for r in range(n_req):
        differ = np.flatnonzero(got.tokens[r] != plain.tokens[r])
        upto = n_new if len(differ) == 0 else int(differ[0]) + 1
        step_diff = max(step_diff, float((got.step_logits[r, :upto]
                                          - plain.step_logits[r, :upto])
                                         .abs().max()))
        same_history += upto
    top2 = plain.step_logits.topk(2, dim=-1).values
    margin = (top2[..., 0] - top2[..., 1]).cpu().numpy()  # (B, n_new)
    compared, token_fault = [], None
    for r in range(n_req):
        steps = 0
        for i in range(n_new):
            steps += 1
            if margin[r, i] < LOGIT_TOL:
                break  # near-tie: either token is right, paths may part
            if got.tokens[r, i] != plain.tokens[r, i] and token_fault is None:
                token_fault = (f"request {r} step {i}: token "
                               f"{got.tokens[r, i]} != plain "
                               f"{plain.tokens[r, i]} at margin "
                               f"{margin[r, i]}")
        compared.append(steps)
    return {"ok": bool(diff <= LOGIT_TOL and step_diff <= LOGIT_TOL
                       and token_fault is None),
            "prefill_diff": diff,
            "scale": float(plain.prefill_logits.abs().max()),
            "step_diff": step_diff, "same_history": same_history,
            "compared": compared, "token_fault": token_fault,
            "same": int((got.tokens == plain.tokens).all(axis=1).sum())}


def leaky_attention(q, k, v, *, causal=True):
    """A planted fault: the plain attention with its causal mask off by one,
    so that query i also sees key i + 1."""
    s, dh = q.shape[2], q.shape[3]
    group = q.shape[1] // k.shape[1]
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    scores = torch.matmul(q.float(), kf.transpose(-1, -2)) / (dh ** 0.5)
    keep = (torch.arange(s, device=q.device)[:, None] + 1
            >= torch.arange(k.shape[2], device=q.device)[None, :])
    scores = torch.where(keep, scores, -1e30)
    return torch.softmax(scores, dim=-1).matmul(vf).to(q.dtype)


def planted_faults(cfg, params, prompts, plain) -> None:
    """Shows what each check reads under a wrong attention: the plain path
    with the causal mask off by one in every layer, in the middle layer and
    in the last layer alone.  The per-layer check must flag every faulty
    layer; the end-to-end rule must reject the fault in every layer and its
    readings are printed for the other two."""
    n = cfg.n_layers
    for where, layers in (("every layer", range(n)),
                          (f"the middle layer ({n // 2})", (n // 2,)),
                          (f"the last layer ({n - 1})", (n - 1,))):
        engine = ServeEngine(cfg, params, ParallelConfig(attention_impl="ref"))
        res, seen = record_attention(
            lambda: engine.generate(prompts, LM_NEW, LM_MAX_LEN,
                                    keep_logits=True),
            n, fault=(set(layers), leaky_attention))
        ratios = layer_ratios(seen)
        del seen
        flagged = [i for i, r in enumerate(ratios) if r > 1]
        reading = compare_lm(res, plain)
        log(f"[lm:fault] causal mask off by one in {where}: per-layer "
            f"check flags layers {flagged} (largest ratio to the B6 "
            f"tolerance {max(ratios)}); end to end: prefill logits max "
            f"|diff| {reading['prefill_diff']}, step logits max |diff| "
            f"{reading['step_diff']} over {reading['same_history']} "
            f"shared-history steps, first token fault "
            f"{reading['token_fault']}; rejected end to end: "
            f"{not reading['ok']}")
        check(flagged == sorted(layers), f"the per-layer check flagged "
              f"{flagged} for a planted fault in {sorted(layers)}")
        if where == "every layer":
            check(not reading["ok"], f"the end-to-end rule let a planted "
                  f"fault ({where}) through: {reading}")


def lm_phase(seed: int, card: str) -> tuple[tuple, dict, dict]:
    """llama3-8B served by the kernel path (attention_impl None: the flash
    kernel on CUDA), then by the plain path (attention_impl "ref"), both
    through ServeEngine.generate on one set of random weights, checked
    against each other, end to end and layer by layer; then the planted
    faults; then the same model with CabinEmbed (cabinembed_run).  Returns
    the (q, k, v) of the kernel path's first attention call, its launch
    counts and the CabinEmbed run's."""
    cfg = get_config(LM_ARCH)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    torch.cuda.synchronize()
    held_before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = T.init_params(cfg, gen, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = T.count_params(params)
    prompts = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT),
                            generator=gen, device="cuda", dtype=torch.int32)
    log(f"[lm] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads / {cfg.n_kv_heads} KV heads, head_dim "
        f"{cfg.resolved_head_dim}, {n_params} parameters in "
        f"{cfg.precision.param_dtype}, drawn on the card in {init_s:.1f}s")
    runs = {}
    for path, impl in (("kernel", None), ("plain", "ref")):
        engine = ServeEngine(cfg, params, ParallelConfig(attention_impl=impl))
        # warm-up (libraries loaded, first-use costs paid), not measured
        engine.generate(prompts[:1, :64], 2, 128)
        torch.cuda.reset_peak_memory_stats()
        build.reset_launches()
        res = engine.generate(prompts, LM_NEW, LM_MAX_LEN, keep_logits=True)
        launches = dict(build.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2**30
        prefill_runs = [engine.generate(prompts, 1, LM_MAX_LEN).prefill_s
                        for _ in range(TIMED_RUNS)]
        if path == "kernel":
            # the same prefill once more, each attention's inputs and
            # output copied for the per-layer check (outside the measured
            # run, whose time and memory the copies would distort)
            again, seen = record_attention(lambda: engine.generate(
                prompts, 1, LM_MAX_LEN, keep_logits=True), cfg.n_layers)
            rerun_diff = float((again.prefill_logits
                                - res.prefill_logits).abs().max())
            ratios = layer_ratios(seen)
            qkv = seen[0]
            del seen, again
        check(res.tokens.shape == (LM_BATCH, LM_NEW), f"{path}: tokens")
        check(bool(torch.isfinite(res.prefill_logits).all()),
              f"{path}: prefill logits not finite")
        check(bool(torch.isfinite(res.step_logits).all()),
              f"{path}: step logits not finite")
        want = {k: 0 for k in launches}
        if path == "kernel":
            want["flash_attention"] = cfg.n_layers  # one prefill
        check(launches == want, f"{path}: kernel launches {launches}, "
              f"expected {want}")
        runs[path] = res
        if path == "kernel":
            kernel_launches = launches
        log(f"[lm:{path}] prefill {LM_BATCH} x {LM_PROMPT} tokens "
            f"{res.prefill_s:.3f}s ({LM_BATCH * LM_PROMPT / res.prefill_s:.1f}"
            f" tokens/s), decode {LM_NEW} steps {res.decode_s:.3f}s "
            f"({LM_BATCH * LM_NEW / res.decode_s:.1f} tokens/s), peak device "
            f"memory {peak:.2f} GiB, launches {launches}; {TIMED_RUNS} more "
            f"prefills alone: {prefill_runs} s (median "
            f"{float(np.median(prefill_runs))} s) [{card}]")

    reading = compare_lm(runs["kernel"], runs["plain"])
    check(reading["ok"], f"the kernel LM path disagrees with the plain one: "
          f"{reading}")
    log(f"[lm] kernel vs plain path: prefill logits max |diff| "
        f"{reading['prefill_diff']} (tolerance {LOGIT_TOL}; largest |logit| "
        f"{reading['scale']}); greedy tokens compared for "
        f"{reading['compared']} steps per request (up to the first plain "
        f"top-1/top-2 margin under {LOGIT_TOL}); {reading['same']} of "
        f"{LM_BATCH} requests identical over all {LM_NEW} tokens; step "
        f"logits max |diff| {reading['step_diff']} over the "
        f"{reading['same_history']} steps whose earlier tokens the paths "
        f"shared")
    worst = int(np.argmax(ratios))
    check(max(ratios) <= 1, f"the flash kernel in layer {worst} differs "
          f"from the plain attention on its inputs by {ratios[worst]} of "
          f"the tolerance")
    log(f"[lm] per layer, each prefill attention output of the kernel path "
        f"against the plain attention on the same inputs: largest ratio to "
        f"the B6 tolerance {ratios[worst]} (layer {worst}), layer 0 "
        f"{ratios[0]}; the recorded prefill's logits differ from the "
        f"measured one's by {rerun_diff}")
    q, k, v, causal, _ = qkv
    check(causal, "the prefill attention is causal")
    planted_faults(cfg, params, prompts, runs["plain"])
    # the dense model's weights, engines and logits go before CabinEmbed's
    # are drawn: what stays is the first attention call's record
    del engine, params, runs, res
    torch.cuda.empty_cache()
    kept = sum(t.numel() * t.element_size() for t in qkv
               if isinstance(t, torch.Tensor))
    left = torch.cuda.memory_allocated() - held_before
    check(left <= kept + LM_LEFT_SLACK, f"{left} bytes of the dense run "
          f"left on the card, {kept} expected")
    log(f"[lm] dense model freed: {left} bytes allocated beyond the phase's "
        f"start ({kept} of them the recorded first attention call)")
    hashed = cabinembed_run(cfg, gen, prompts, n_params, card)
    return (q, k, v), kernel_launches, hashed


def cabinembed_run(cfg, gen: torch.Generator, prompts: torch.Tensor,
                   dense_params: int, card: str) -> dict:
    """llama3-8B with the hashed (CabinEmbed) embedding and tied head at
    full width and depth, weights drawn on the card (the dense model's
    freed first): the card's hashed_embed / hashed_logits against the
    same functions on CPU copies (embeddings bit for bit, logits within
    HASHED_LOGIT_RTOL of their largest |value|), then a prefill and
    HASHED_NEW greedy tokens through the kernel path and the plain path,
    held to each other by the end-to-end rule, and the kernel path's 32
    prefill attention outputs each to B6's tolerance.  Returns the kernel
    path's launch counts and the run's record."""
    hcfg = dataclasses.replace(cfg, hashed_embedding=True,
                               hashed_embedding_buckets=HASHED_BUCKETS,
                               hashed_embedding_k=HASHED_K)
    params = T.init_params(hcfg, gen, device="cuda")
    n_params = T.count_params(params)
    log(f"[lm:cabinembed] {hcfg.name} with CabinEmbed: {HASHED_BUCKETS} "
        f"buckets (this phase's choice; the reference sets a bucket count "
        f"only in a smoke test, 64), k = {HASHED_K}: table "
        f"{HASHED_BUCKETS} x {hcfg.d_model} in place of {hcfg.vocab_size} x "
        f"{hcfg.d_model} and no separate head; {n_params} parameters "
        f"against the dense model's {dense_params} "
        f"({n_params / dense_params:.4f} of them)")
    table = params["hashed_embed"]
    on_cpu = {"table": table["table"].cpu()}
    toks = prompts[:1, :64]
    check(torch.equal(hemb.hashed_embed(hcfg, table, toks).cpu(),
                      hemb.hashed_embed(hcfg, on_cpu, toks.cpu())),
          "hashed_embed on the card != on the CPU")
    xh = torch.randn((1, 64, hcfg.d_model), generator=gen, device="cuda"
                     ).to(torch.bfloat16)
    want = hemb.hashed_logits(hcfg, on_cpu, xh.cpu())
    logit_err = float((hemb.hashed_logits(hcfg, table, xh).cpu()
                       - want).abs().max())
    logit_scale = float(want.abs().max())
    check(logit_err <= HASHED_LOGIT_RTOL * logit_scale,
          f"hashed_logits on the card differ from the CPU's by {logit_err}"
          f" (largest |logit| {logit_scale})")
    log(f"[lm:cabinembed] card against CPU copies: hashed_embed "
        f"bit-identical over {toks.numel()} tokens; hashed_logits max "
        f"|diff| {logit_err} (tolerance {HASHED_LOGIT_RTOL} of the largest "
        f"|logit| {logit_scale})")
    runs, rec = {}, {"params": n_params, "dense_params": dense_params,
                     "buckets": HASHED_BUCKETS, "k": HASHED_K,
                     "logit_err": logit_err}
    for path, impl in (("kernel", None), ("plain", "ref")):
        engine = ServeEngine(hcfg, params,
                             ParallelConfig(attention_impl=impl))
        engine.generate(prompts[:1, :64], 2, 128)  # warm-up
        torch.cuda.reset_peak_memory_stats()
        build.reset_launches()
        res = engine.generate(prompts, HASHED_NEW, LM_MAX_LEN,
                              keep_logits=True)
        launches = dict(build.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2**30
        want = {k: 0 for k in launches}
        if path == "kernel":
            want["flash_attention"] = hcfg.n_layers  # one prefill
            _, seen = record_attention(lambda: engine.generate(
                prompts, 1, LM_MAX_LEN), hcfg.n_layers)
            ratios = layer_ratios(seen)
            del seen
            kernel_launches = launches
        check(launches == want, f"cabinembed {path}: kernel launches "
              f"{launches}, expected {want}")
        check(bool(torch.isfinite(res.prefill_logits).all())
              and bool(torch.isfinite(res.step_logits).all()),
              f"cabinembed {path}: logits not finite")
        runs[path] = res
        rec[path] = {"prefill_s": res.prefill_s, "decode_s": res.decode_s,
                     "peak_gib": peak}
        log(f"[lm:cabinembed:{path}] prefill {LM_BATCH} x {LM_PROMPT} "
            f"tokens {res.prefill_s:.3f}s, decode {HASHED_NEW} steps "
            f"{res.decode_s:.3f}s ({LM_BATCH * HASHED_NEW / res.decode_s:.1f}"
            f" tokens/s), peak device memory {peak:.2f} GiB, launches "
            f"{launches} [{card}]")
    reading = compare_lm(runs["kernel"], runs["plain"])
    check(reading["ok"], f"the CabinEmbed kernel path disagrees with the "
          f"plain one: {reading}")
    worst = int(np.argmax(ratios))
    check(max(ratios) <= 1, f"CabinEmbed: the flash kernel in layer {worst}"
          f" differs from the plain attention by {ratios[worst]} of the "
          f"tolerance")
    rec.update(prefill_diff=reading["prefill_diff"],
               step_diff=reading["step_diff"], same=reading["same"],
               layer_ratio_max=ratios[worst])
    log(f"[lm:cabinembed] kernel vs plain path: prefill logits max |diff| "
        f"{reading['prefill_diff']} (tolerance {LOGIT_TOL}; largest |logit| "
        f"{reading['scale']}); tokens compared for {reading['compared']} "
        f"steps per request; {reading['same']} of {LM_BATCH} requests "
        f"identical over {HASHED_NEW} tokens; per layer, the largest ratio "
        f"to the B6 tolerance {ratios[worst]} (layer {worst})")
    del params, runs
    torch.cuda.empty_cache()
    return {"launches": kernel_launches, "record": rec}


# ---------------------------------------------------------------------------
# the paper's experiments at Table 1's full widths
# ---------------------------------------------------------------------------


def paper_dims() -> dict:
    """Each figure's sketch dimensions at full width: the twin's
    (benchmarks/bench_paper.py) d over its scale, rounded up to 32."""
    return {fig: tuple(paper.full_width_dim(d, scale) for d in dims)
            for fig, (scale, dims) in PAPER_TWINS.items()}


def paper_rows(name: str) -> int:
    """PAPER_ROWS, or the dataset's whole Table 1 count where smaller
    (NIPS: 1,500 points)."""
    return min(PAPER_ROWS, paper.TABLE1[name].n_points)


def start_paper_samples(pool, seed: int) -> dict:
    """Draws, in worker processes, each dataset's rows at full width
    (seed + 1, fig3's seed) and as many clustered rows (k = PAPER_K,
    seed + 5, fig6's), BrainCell's plain rows first: the generator's
    rng.choice over n_dims is O(n_dims) a row on the host."""
    jobs = {}
    for name in sorted(paper.TABLE1,
                       key=lambda n: -paper.TABLE1[n].n_dims):
        jobs[(name, 0)] = pool.apply_async(
            timed_sample, (name, paper_rows(name), seed + 1, 0))
    for name in paper.TABLE1:
        jobs[(name, PAPER_K)] = pool.apply_async(
            timed_sample, (name, paper_rows(name), seed + 5, PAPER_K))
    return jobs


def timed_sample(name: str, rows: int, seed: int, clusters: int):
    t0 = time.perf_counter()
    smp = paper.sample(name, 1.0, rows, seed=seed, clusters=clusters)
    return smp, time.perf_counter() - t0


def baselines_card_vs_cpu(smp, d: int, device) -> None:
    """Each baseline sketch of a few rows' BinEm bits on the card equals
    the same function on CPU copies, bit for bit."""
    x = smp.head(PAPER_CPU_ROWS).dense(device)
    n = smp.spec.n_dims
    bits = binem(CabinParams.create(n, d, seed=0), x)
    bits_cpu = bits.cpu()
    check(torch.equal(bits_cpu, binem(CabinParams.create(n, d, seed=0),
                                      x.cpu())),
          f"{smp.spec.name}: BinEm on the card != on the CPU")
    bp = baselines.BaselineParams(n, d, 0)
    for name in ("bcs", "hlsh", "fh", "simhash"):
        fn = getattr(baselines, f"{name}_sketch")
        check(torch.equal(fn(bp, bits).cpu(), fn(bp, bits_cpu)),
              f"{smp.spec.name}: {name} sketch on the card != on the CPU")


def once(fn):
    """fn()'s result and its device time in ms (one run, L2 flushed)."""
    box = []
    ms = cuda_ms(lambda: box.append(fn()), 1, warmup=0)
    return box[-1], ms


def paper_kernel_checks(smp, d: int, dims: list, rates: dict,
                        widest: dict, device) -> None:
    """B3, B4 and B5 against their plain versions, bit for bit, at the
    shapes the figures give them: B5 on all rows at each figure's d and at
    Theorem 2's d; B4 on all rows' sketches at the widest of these d; B3's
    full all-pairs output over all rows, both outputs on those sketches
    and inner only on the exact distances' (attribute, category) bitmaps,
    held on its first and last PAPER_B3_ROWS rows (the last include the
    kernel's partial row tile) against the plain version on the same rows
    (the plain version's cost over all 2,000^2 pairs is half a minute).
    Keeps the widest of each kernel in `widest`, with its times at the
    checked shape and its bound."""
    x = smp.dense(device)
    name = smp.spec.name
    n_rows = x.shape[0]

    def b5_plain(kw):
        step = max(1, 2**26 // x.shape[1])
        return torch.cat([dense_ops.cabin_build_ref(x[r:r + step], **kw)
                          for r in range(0, n_rows, step)])

    for dd in sorted(set(dims) | {d}):
        cp = CabinParams.create(smp.spec.n_dims, dd, seed=10)
        kw = dict(d=dd, psi_seed=cp.psi_seed, pi_seed=cp.pi_seed)
        b5_want, b5_plain_ms = once(lambda: b5_plain(kw))
        sk = dense_ops.cabin_build(x, **kw)
        check(torch.equal(sk, b5_want), f"{name}: cabin_build != plain "
              f"version at n = {smp.spec.n_dims}, d = {dd}")
        del b5_want
    # the loop ends at the widest d
    b5_ms = cuda_ms(lambda: dense_ops.cabin_build(x, **kw), 3)
    w = sk.shape[1]
    b4_want, b4_plain_ms = once(lambda: hamming_ops.row_popcount_ref(sk))
    check(torch.equal(hamming_ops.row_popcount(sk), b4_want),
          f"{name}: row_popcount != plain version at W = {w}")
    ends = torch.arange(n_rows, device=x.device)
    ends = ends[(ends < PAPER_B3_ROWS) | (ends >= n_rows - PAPER_B3_ROWS)]
    got = hamming_ops.pair_stats(sk, sk)
    want = hamming_ops.pair_stats_ref(sk[ends], sk)
    check(all(torch.equal(g[ends], r) for g, r in zip(got, want)),
          f"{name}: pair_stats != plain version at W = {w}")
    del got, want
    rows, attrs = nonzero_2d(x)
    vals = x[rows, attrs].to(torch.int64)
    _, key = torch.unique(attrs * (int(vals.max()) + 1) + vals,
                          return_inverse=True)
    bitmap = paper._bitmap(rows, key, n_rows)
    r5, c5 = nonzero_2d(x)
    live = len(r5)
    psi_hits = int(hashing.psi_bits(c5, x[r5, c5], cp.psi_seed).sum())
    x_numel, x_width = x.numel(), x.shape[1]
    del x, rows, attrs, vals, key, r5, c5
    bq = bitmap[ends].contiguous()
    m, n, wb = bq.shape[0], bitmap.shape[0], bitmap.shape[1]
    b3_want, b3_plain_ms = once(lambda: hamming_ops.pair_stats_ref(
        bq, bitmap, op_ham=False)[0])
    check(torch.equal(hamming_ops.pair_stats(bitmap, bitmap, op_ham=False)
                      [0][ends], b3_want),
          f"{name}: pair_stats != plain version on the key bitmaps, "
          f"W = {wb}")
    log(f"[paper:{name}] bit-identical to the plain versions: B5 on "
        f"{n_rows} x {x_width} at d = {sorted(set(dims) | {d})} (Theorem "
        f"2's d = {d}); at the widest d = {kw['d']} (W = {w}) B4 on "
        f"({sk.shape[0]}, {w}) and B3's {n} x {n} output on {w} words "
        f"(both outputs) and on the key bitmaps' {wb} words (inner only), its rows 0-{PAPER_B3_ROWS - 1} and "
        f"{n - PAPER_B3_ROWS}-{n - 1} against the plain version")

    def keep(kernel, shape_w, entry):
        if kernel not in widest or widest[kernel]["w"] < shape_w:
            b_ms, b_by = bound(entry.pop("bytes"), entry.pop("ops"), rates)
            widest[kernel] = dict(entry, w=shape_w, bound_ms=b_ms,
                                  bound_by=b_by, dataset=name,
                                  max_abs_err=0)

    keep("cabin_build", smp.spec.n_dims, {
        "shape": f"{n_rows} x {x_width} -> d = {kw['d']}",
        "ms": b5_ms,
        "plain_ms": b5_plain_ms,
        # every category read once, every sketch word written; a zero
        # test per value, 22 operations per live value and 14 where psi
        # is 1 (as the kernel phase counts B5)
        "bytes": x_numel * 4 + n_rows * w * 4,
        "ops": {"int32": x_numel + live * 22 + psi_hits * 14}})
    keep("pair_stats", wb, {
        "shape": f"{m} x {n} x {wb} words (the first and last "
                 f"{PAPER_B3_ROWS} rows), inner only",
        "ms": cuda_ms(lambda: hamming_ops.pair_stats(bq, bitmap,
                                                     op_ham=False), 3),
        "plain_ms": b3_plain_ms,
        f"ms_{n}x{n}": cuda_ms(lambda: hamming_ops.pair_stats(
            bitmap, bitmap, op_ham=False), 3),
        f"bound_ms_{n}x{n}": bound((2 * n) * wb * 4 + n * n * 4,
                                   pair_ops_needed(n, n, wb), rates)[0],
        "bytes": (m + n) * wb * 4 + m * n * 4,
        "ops": pair_ops_needed(m, n, wb)})
    keep("row_popcount", w, {
        "shape": f"({sk.shape[0]}, {w})",
        "ms": cuda_ms(lambda: hamming_ops.row_popcount(sk), 10),
        "plain_ms": b4_plain_ms,
        "bytes": sk.numel() * 4 + sk.shape[0] * 4,
        "ops": {"int32": sk.numel(), "popc": sk.numel()}})


def paper_summary(record: dict) -> dict:
    """The paper phase's record without the per-figure detail the log
    already holds: seconds and each figure's headline numbers."""
    out = {k: record[k] for k in ("dims", "phase_s", "peak_gib", "wait_s")}
    for name, res in record["results"].items():
        fig3 = res.get("fig3", {})
        top = max(paper_dims()["fig3"])
        out[name] = {
            "seconds": res["seconds"],
            "speedups": {m: res["fig2"].get(f"speedup_{m}")
                         for m in paper.BASELINES},
            "rmse_top_d": {m: fig3.get(f"{name}.{m}.d{top}")
                           for m in paper.METHODS},
            "mae": res["table4"].get("mae"),
            "theorem2": {k: res["theorem2"].get(k)
                         for k in ("frac_within", "bound", "d", "s")}}
    return out


def paper_phase(jobs: dict, card: str, rates: dict, device) -> dict:
    """Every figure function of repro_torch.experiments.paper on each of
    Table 1's six datasets at full width, PAPER_ROWS rows, with the launch
    counts set to 0 just before and B3-B5 risen just after; then the
    baselines on the card against the CPU and B3-B5 against their plain
    versions at each dataset's widest shapes.  Fails if any ordering the
    reference asserts does not hold (after running every figure)."""
    phase_t0 = time.perf_counter()
    dims = paper_dims()
    log(f"[paper] full-width sketch dimensions (twin d / twin scale, up to "
        f"a multiple of 32): {dims}; Theorem 2's d = sketch_dim(max nnz)")
    t0 = time.perf_counter()
    samples = {key: job.get() for key, job in jobs.items()}
    wait_s = time.perf_counter() - t0
    log(f"[paper] rows drawn on the host in {PAPER_WORKERS} worker "
        f"processes, started when the corpus phase ended: " + ", ".join(
            f"{n}{'' if c == 0 else f' (k={c})'} {s:.1f}s"
            for (n, c), (_, s) in samples.items())
        + f"; the phase waited {wait_s:.1f}s for them")
    samples = {key: smp for key, (smp, _) in samples.items()}
    out, failures = {}, []
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    for name in paper.TABLE1:
        plain, clus = samples[(name, 0)], samples[(name, PAPER_K)]
        spec = plain.spec
        runs = {
            "fig2": lambda: paper.fig2_table3_reduction_speed(
                d=dims["fig2"][0], data=plain, device=device),
            "fig3": lambda: paper.fig3_rmse(
                dims=dims["fig3"], names=(name,), data={name: plain},
                device=device),
            "fig4": lambda: paper.fig4_binem_variance(
                d=dims["fig4"][0], data=plain, device=device),
            "fig5": lambda: paper.fig5_step2_variance(
                d=dims["fig5"][0], data=plain, device=device),
            "fig6to10": lambda: paper.fig6to10_clustering(
                k=PAPER_K, dims=dims["fig6to10"], data=clus, device=device),
            "table4": lambda: paper.table4_heatmap(
                d=dims["table4"][0], data=plain, device=device),
            "theorem2": lambda: paper.theorem2_check(data=plain,
                                                     device=device)}
        res = out[name] = {"n_dims": spec.n_dims, "density": spec.density,
                           "n_categories": spec.n_categories,
                           "rows": plain.n_rows, "seconds": {}}
        for fig, run in runs.items():
            t0 = time.perf_counter()
            try:
                res[fig] = run()
                if fig == "fig5":  # the per-trial errors stay out of the log
                    for v in res[fig].values():
                        v.pop("errors")
            except AssertionError as err:
                failures.append(f"{name} {fig}: {err}")
                res[fig] = {"failed": str(err)[:500]}
            torch.cuda.synchronize(device)
            res["seconds"][fig] = time.perf_counter() - t0
        log(f"[paper:{name}] n = {spec.n_dims}, {spec.n_categories} "
            f"categories, density {spec.density}, {plain.n_rows} rows: "
            f"{json.dumps(res, default=str)}")
        fig2 = res["fig2"]
        if "seconds" in fig2:
            log(f"[paper:{name}] Table 3, Cabin's sketching speedup over "
                + ", ".join(f"{m} {fig2[f'speedup_{m}']:.2f}x"
                            for m in paper.BASELINES)
                + f" ({plain.n_rows} rows, d = {fig2['d']}) [{card}]")
    launches = dict(build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[paper] kernel launches: {launches}; peak device memory "
        f"{peak:.2f} GiB; figures {time.perf_counter() - phase_t0:.1f}s")
    for kernel in PAPER_KERNELS:
        check(launches[kernel] > 0,
              f"kernel {kernel} was not launched in the paper phase")
    widest = {}
    for name in paper.TABLE1:
        plain = samples[(name, 0)]
        baselines_card_vs_cpu(plain, dims["fig2"][0], device)
        thm2 = out[name]["theorem2"]
        if "d" in thm2:
            paper_kernel_checks(plain, thm2["d"],
                                [dd for ds in dims.values() for dd in ds],
                                rates, widest, device)
    log(f"[paper] baseline sketches of {PAPER_CPU_ROWS} rows a dataset on "
        f"the card equal the CPU's, bit for bit; widest shapes: "
        f"{json.dumps(widest)}")
    for f in failures:
        log(f"[paper] FAILED {f}")
    check(not failures, f"{len(failures)} of the reference's orderings "
          f"failed in the paper phase")
    phase_s = time.perf_counter() - phase_t0
    log(f"[paper] {phase_s:.1f}s in all")
    return {"launches": launches, "widest": widest,
            "record": {"results": out, "dims": dims, "phase_s": phase_s,
                       "peak_gib": peak, "wait_s": wait_s}}


# ---------------------------------------------------------------------------
# kernels against their plain versions
# ---------------------------------------------------------------------------


def topk_ops_needed(nq: int, m: int, w: int) -> dict:
    """Operations a k-best of nq queries over m rows of w words needs on
    the int8 tensor cores, which B2 runs its inner products on: per (query,
    row, word) 32 multiply-adds of 0/1 bytes, 2 operations each; per (row,
    word) a popcount and an add for the row weight, the row's alone."""
    return {"int8": 2 * 32 * nq * m * w, "int32": m * w, "popc": m * w}


def pair_ops_needed(m: int, n: int, w: int) -> dict:
    """Operations all-pairs inner products of m x n rows of w words need
    on the int8 tensor cores, which B3 runs them on: per (row, row, word)
    32 multiply-adds of 0/1 bytes, 2 operations each; per (row, word) a
    popcount and an add for the row weights that hamming reads."""
    return {"int8": 2 * 32 * m * n * w, "popc": (m + n) * w,
            "int32": (m + n) * w}


def pair_stats_edges(rows: torch.Tensor) -> int:
    """B3 against its plain version, every output switch, at ragged
    shapes around its 256-row x 64-query tile and its 16-word steps, on
    the card; returns the number of shapes."""
    shapes = [(m, n, w) for m in (1, 65) for n in (127, 4097)
              for w in (3, 33, 128)]
    for m, n, w in shapes:
        a = rows[:m, :w].contiguous()
        b = rows[-n:, -w:].contiguous()
        for op_inner, op_ham in ((True, True), (True, False), (False, True)):
            got = hamming_ops.pair_stats(a, b, op_inner=op_inner,
                                         op_ham=op_ham)
            want = hamming_ops.pair_stats_ref(a, b, op_inner=op_inner,
                                              op_ham=op_ham)
            check(all((g is None and r is None) or torch.equal(g, r)
                      for g, r in zip(got, want)),
                  f"pair_stats != plain version at {(m, n, w)} "
                  f"(inner {op_inner}, hamming {op_ham})")
    log(f"[kernel:pair_stats] bit-identical to the plain version at "
        f"{len(shapes)} edge shapes (m, n, w) {shapes}, every output switch")
    return len(shapes)


def topk_bytes(nq: int, m: int, w: int, k: int) -> int:
    """The queries and the m valid rows read once, the Cham table, and
    k (value, index) pairs per query written."""
    return (nq + m) * w * 4 + (32 * w + 1) * 4 + nq * k * 8


def flash_sass(lib: Path) -> dict:
    """HMMA (tensor-core) instruction counts per flash kernel instance in
    the built library's SASS, and each instance's resource use (a spill
    shows as a stack frame or local memory).  Fails unless every bf16
    instance has HMMA."""
    tool = str(Path(build.find_nvcc()).with_name("cuobjdump"))
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    hmma = {}
    for part in sass.split("Function : ")[1:]:
        name = part.split(None, 1)[0]
        if "flash_" in name:
            hmma[name] = sum("HMMA" in line for line in part.splitlines())
    usage = subprocess.run([tool, "-res-usage", str(lib)],
                           capture_output=True, text=True, check=True).stdout
    lines = usage.splitlines()
    for i, line in enumerate(lines):
        if "flash_mma_kernel" in line and i + 1 < len(lines):
            log(f"[build:flash_attention] {line.strip()} "
                f"{lines[i + 1].strip()}")
    mma = {n: c for n, c in hmma.items() if "flash_mma_kernel" in n}
    check(len(mma) == 16 and all(c > 0 for c in mma.values()),
          f"bf16 flash kernels without HMMA in their SASS: {mma}")
    f32 = sum(c for n, c in hmma.items() if "flash_f32_kernel" in n)
    log(f"[build:flash_attention] SASS HMMA per bf16 instance "
        f"{sorted(mma.values())}; in the f32 instances {f32}")
    return {"hmma_per_bf16_instance": sorted(mma.values()),
            "hmma_in_f32_instances": f32}


def check_res_usage(lib: Path, kernel: str, what: str, instances: int,
                    tensor_ops: tuple = ()) -> dict:
    """Registers, stack and local memory (`cuobjdump -res-usage`) and the
    int8 tensor-core instructions (`cuobjdump -sass` lines holding one of
    `tensor_ops`: IMMA for mma.sync, IGMMA for wgmma) of every template
    instance of `kernel` in a built library, keyed by the instance's
    mangled template arguments.  Fails unless there are `instances` of
    them, none keeps a stack frame or local memory (a spill), and, given
    `tensor_ops`, each runs such instructions."""
    tool = str(Path(build.find_nvcc()).with_name("cuobjdump"))

    def dump(flag: str) -> str:
        return subprocess.run([tool, flag, str(lib)], capture_output=True,
                              text=True, check=True).stdout

    def instance(line: str) -> str:
        return line.split(kernel, 1)[1].split("EEEv")[0]

    lines = dump("-res-usage").splitlines()
    usage = {}
    for i, line in enumerate(lines):
        if (kernel in line and i + 1 < len(lines)
                and "REG:" in lines[i + 1]):
            fields = dict(f.split(":", 1) for f in lines[i + 1].split()
                          if ":" in f)
            usage[instance(line)] = {f: int(fields[f]) for f in ("REG", "STACK",
                                                                 "LOCAL")}
    for part in dump("-sass").split("Function : ")[1:]:
        name = part.split(None, 1)[0]
        if kernel in name and instance(name) in usage:
            usage[instance(name)]["tensor"] = sum(
                any(op in line for op in tensor_ops)
                for line in part.splitlines())
    log(f"[build:{lib.name.split('-')[0]}] {kernel} instances ({what}) -> "
        f"registers / stack / local bytes / {'/'.join(tensor_ops) or 'no'} "
        f"tensor-core instructions: {usage}")
    check(len(usage) == instances,
          f"expected {instances} {kernel} instances, got {usage}")
    check(all(u["STACK"] == 0 and u["LOCAL"] == 0 for u in usage.values()),
          f"a {kernel} instance uses a stack or local memory: {usage}")
    check(not tensor_ops or all(u.get("tensor", 0) > 0
                                for u in usage.values()),
          f"a {kernel} instance has no {'/'.join(tensor_ops)} (int8 "
          f"tensor-core) instruction: {usage}")
    return usage


def kernel_phases(params: CabinParams, idx: torch.Tensor, val: torch.Tensor,
                  dense: torch.Tensor, runs: dict, qkv: tuple,
                  launches: dict, rates: dict, sass: dict,
                  usage: dict) -> list[dict]:
    out = []
    w = packing.packed_width(SKETCH_DIM)
    rate_text = (f"HBM 3.35e12 B/s; int32 {rates['int32']:.4g} op/s, popc "
                 f"{rates['popc']:.4g} op/s at {rates['sms']} SMs x "
                 f"{rates['mhz']:.0f} MHz; bf16 {rates['bf16']:.4g} flop/s, int8 "
                 f"{rates['int8']:.4g} op/s")

    def record(name, err, ms, plain_ms, n_bytes, ops, library_ms=None,
               tolerance="0: bit-identical to the plain version", **extra):
        b_ms, b_by = bound(n_bytes, ops, rates)
        out.append({"name": name, "route": "cuda", "source": SOURCES[name],
                    "replaces": REPLACES[name], "launches": launches[name],
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": b_ms, "bound_by": b_by,
                    "library_ms": library_ms, **extra})
        lib = "" if library_ms is None else f", library {library_ms:.4f} ms"
        log(f"[kernel:{name}] max_abs_err {err} (tolerance {tolerance}) "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms{lib}, bound "
            f"{b_ms:.4f} ms ({b_by}: {n_bytes:.0f} bytes, operations {ops};"
            f" {rate_text})")

    # B1: one ingest chunk, (16384, 298) COO -> (16384, 128)
    ci, cv = idx[:CHUNK].contiguous(), val[:CHUNK].contiguous()
    kw = dict(d=SKETCH_DIM, psi_seed=params.psi_seed, pi_seed=params.pi_seed)
    got = sparse_ops.cabin_build_sparse(ci, cv, **kw)
    want = sparse_ops.cabin_build_sparse_ref(ci, cv, **kw)
    check(torch.equal(got, want), "cabin_build_sparse != plain version")
    live = int((cv != 0).sum())
    psi_hits = int(hashing.psi_bits(ci, cv, params.psi_seed).sum())
    b1_runs = [cuda_ms(lambda: sparse_ops.cabin_build_sparse(ci, cv, **kw), 20)
               for _ in range(TIMED_RUNS)]
    b1_plan = sparse_ops.plan(M_SLOTS, SKETCH_DIM, ci.data_ptr(),
                              cv.data_ptr())
    # the memory rate a plain streaming pass reaches at this size, as a
    # yardstick: one elementwise add reads both inputs and writes one
    # (not the same function; the port never calls it)
    stream_ms = cuda_ms(lambda: torch.add(ci, cv), 20)
    b1_read = (ci.numel() + cv.numel() + CHUNK * w) * 4  # every index read
    stream_bytes = 3 * ci.numel() * 4
    # four chunks in one launch: the rate at which B1 moves more bytes,
    # apart from what one launch costs whatever its size
    fi, fv = idx[:4 * CHUNK].contiguous(), val[:4 * CHUNK].contiguous()
    check(torch.equal(sparse_ops.cabin_build_sparse(fi, fv, **kw),
                      sparse_ops.cabin_build_sparse_ref(fi, fv, **kw)),
          "cabin_build_sparse != plain version on four chunks")
    four_ms = cuda_ms(lambda: sparse_ops.cabin_build_sparse(fi, fv, **kw), 10)
    b1_ms = float(np.median(b1_runs))
    log(f"[kernel:cabin_build_sparse] {CHUNK} x {M_SLOTS} slots ({live} "
        f"live), d={SKETCH_DIM}, plan {b1_plan}: {TIMED_RUNS} runs of 20 "
        f"launches {b1_runs} ms (median {b1_ms:.4f} ms, "
        f"{b1_read / b1_ms / 1e9:.3f} TB/s over the {b1_read} bytes it "
        f"moves); a streaming add of the two inputs {stream_ms:.4f} ms "
        f"({stream_bytes / stream_ms / 1e9:.3f} TB/s); four chunks in one "
        f"launch {four_ms:.4f} ms (bit-identical to the plain version), "
        f"{3 * b1_read / (four_ms - b1_ms) / 1e9:.3f} TB/s for the three "
        f"more chunks")
    record("cabin_build_sparse", 0, b1_ms,
           cuda_ms(lambda: sparse_ops.cabin_build_sparse_ref(ci, cv, **kw), 2),
           # every value read, an index only where its value is not 0,
           # every sketch word written
           (ci.numel() + live) * 4 + CHUNK * w * 4,
           # psi per live slot: two fmix32 (8 each), the key add, the
           # category multiply, shift, add and xor, the bit test (22);
           # pi where psi is 1: the key add, one fmix32, the modulo, and
           # the bit's shift, mask, shift and OR (14)
           {"int32": live * 22 + psi_hits * 14}, ms_runs=b1_runs,
           plan=b1_plan._asdict(), res_usage=usage["cabin_build_sparse"],
           bytes_moved=b1_read, stream_ms=stream_ms,
           stream_bytes=stream_bytes, four_chunks_ms=four_ms)

    alive = runs["cham"]["alive"]
    q_sk = runs["cham"]["q_sk"]
    n_alive = alive.shape[0]

    # B4: the row weights of the alive store (radius and pairwise reads)
    got = hamming_ops.row_popcount(alive)
    want = hamming_ops.row_popcount_ref(alive)
    check(torch.equal(got, want), "row_popcount != plain version")
    record("row_popcount", 0,
           cuda_ms(lambda: hamming_ops.row_popcount(alive), 20),
           cuda_ms(lambda: hamming_ops.row_popcount_ref(alive), 2),
           n_alive * w * 4 + n_alive * 4,
           {"int32": n_alive * w, "popc": n_alive * w})

    # B3: the radius scan's tile batch, 64 queries x 65,536 rows, as the
    # main path calls it: inner only (cham), hamming only (hamming); both
    # at once checked too
    qa = q_sk[:N_RADIUS_QUERIES].contiguous()
    rows = alive[:65536].contiguous()
    gi, gh = hamming_ops.pair_stats(qa, rows)
    wi, wh = hamming_ops.pair_stats_ref(qa, rows)
    check(torch.equal(gi, wi) and torch.equal(gh, wh),
          "pair_stats != plain version")
    check(torch.equal(hamming_ops.pair_stats(qa, rows, op_ham=False)[0], wi)
          and torch.equal(hamming_ops.pair_stats(qa, rows,
                                                 op_inner=False)[1], wh),
          "pair_stats with one output != plain version")
    b3_runs = {metric: [cuda_ms(lambda: hamming_ops.pair_stats(
        qa, rows, op_inner=metric == "cham", op_ham=metric == "hamming"), 10)
        for _ in range(TIMED_RUNS)] for metric in ("cham", "hamming")}
    for metric, ms in b3_runs.items():
        log(f"[kernel:pair_stats:{metric}] {qa.shape[0]} x {rows.shape[0]} "
            f"x {w} words, {'inner' if metric == 'cham' else 'hamming'} "
            f"only: {TIMED_RUNS} runs of 10 launches {ms} ms (median "
            f"{float(np.median(ms)):.4f} ms)")
    edges = pair_stats_edges(rows)
    mq, nr = qa.shape[0], rows.shape[0]
    record("pair_stats", 0, float(np.median(b3_runs["cham"])),
           cuda_ms(lambda: hamming_ops.pair_stats_ref(qa, rows, op_ham=False),
                   1),
           (mq + nr) * w * 4 + mq * nr * 4, pair_ops_needed(mq, nr, w),
           hamming_ms=float(np.median(b3_runs["hamming"])), ms_runs=b3_runs,
           edge_shapes=edges, res_usage=usage["pair_stats"])

    # B2: 256 queries against the whole alive store, k = 10, both metrics,
    # and each metric's largest band-walk chunk (rows past m_valid masked)
    errs, ms_runs, plain_ms, chunks, big_k = [], {}, [], {}, {}
    sms = rates["sms"]
    for metric in ("cham", "hamming"):
        cq, cb, ck, cm = runs[metric]["band_chunk"]
        gv, gi = topk_ops.topk_select(cq, cb, ck, d=SKETCH_DIM,
                                      metric=metric, m_valid=cm)
        wv, wi = topk_ops.topk_select_ref(cq, cb, ck, d=SKETCH_DIM,
                                          metric=metric, m_valid=cm)
        check(torch.equal(gi, wi) and torch.equal(gv, wv),
              f"topk_select != plain at the band chunk ({metric})")
        errs.append(float((gv - wv).abs().max()))
        c_ms = cuda_ms(lambda: topk_ops.topk_select(
            cq, cb, ck, d=SKETCH_DIM, metric=metric, m_valid=cm), 3)
        c_plain = cuda_ms(lambda: topk_ops.topk_select_ref(
            cq, cb, ck, d=SKETCH_DIM, metric=metric, m_valid=cm), 1)
        c_bound, _ = bound(topk_bytes(cq.shape[0], cm, w, ck),
                           topk_ops_needed(cq.shape[0], cm, w), rates)
        c_plan = topk_ops.plan(cq.shape[0], cm, ck, w, sms)
        chunks[metric] = {"queries": cq.shape[0], "rows": cb.shape[0],
                          "m_valid": cm, "k": ck, "ms": c_ms,
                          "plain_ms": c_plain, "bound_ms": c_bound,
                          "plan": c_plan._asdict()}
        log(f"[kernel:topk_select:{metric}:band_chunk] {cq.shape[0]} "
            f"queries x {cb.shape[0]} rows ({cm} valid), k={ck}, plan "
            f"{c_plan}: bit-identical to the plain version, kernel "
            f"{c_ms:.4f} ms, plain {c_plain:.4f} ms, bound {c_bound:.4f} ms")
        qs = runs[metric]["q_sk"]
        st = runs[metric]["alive"]
        gv, gi = topk_ops.topk_select(qs, st, K, d=SKETCH_DIM, metric=metric)
        wv, wi = topk_ops.topk_select_ref(qs, st, K, d=SKETCH_DIM,
                                          metric=metric)
        check(torch.equal(gi, wi), f"topk_select ids != plain ({metric})")
        check(torch.equal(gv, wv), f"topk_select values != plain ({metric})")
        errs.append(float((gv - wv).abs().max()))
        ms_runs[metric] = [cuda_ms(lambda: topk_ops.topk_select(
            qs, st, K, d=SKETCH_DIM, metric=metric), 3)
            for _ in range(TIMED_RUNS)]
        plain_ms.append(cuda_ms(lambda: topk_ops.topk_select_ref(
            qs, st, K, d=SKETCH_DIM, metric=metric), 1, warmup=0))
        log(f"[kernel:topk_select:{metric}] {qs.shape[0]} queries x "
            f"{st.shape[0]} rows, k={K}, plan "
            f"{topk_ops.plan(qs.shape[0], st.shape[0], K, w, sms)}: "
            f"{TIMED_RUNS} runs of 3 launches {ms_runs[metric]} ms (median "
            f"{float(np.median(ms_runs[metric])):.4f} ms), plain "
            f"{plain_ms[-1]:.4f} ms")
    nq = q_sk.shape[0]
    record("topk_select", max(errs), float(np.median(ms_runs["cham"])),
           plain_ms[0], topk_bytes(nq, n_alive, w, K),
           topk_ops_needed(nq, n_alive, w), ms_runs=ms_runs,
           hamming_ms=float(np.median(ms_runs["hamming"])),
           plan=topk_ops.plan(nq, n_alive, K, w, sms)._asdict(),
           band_chunks=chunks, big_k=big_k, res_usage=usage["topk_select"])

    # B5: the dense ingest, 4,096 x 141,043 -> (4,096, 128), also equal to
    # the sparse plain version of the same rows
    got = dense_ops.cabin_build(dense, **kw)
    torch.cuda.synchronize()

    def dense_plain():  # in row blocks: the int64 hashing of 577 M values
        return torch.cat([dense_ops.cabin_build_ref(dense[r:r + 512], **kw)
                          for r in range(0, dense.shape[0], 512)])

    check(torch.equal(got, dense_plain()), "cabin_build != plain version")
    d_idx, d_val = runs["dense_coo"]
    check(torch.equal(got, sparse_ops.cabin_build_sparse_ref(
        d_idx, d_val, **kw)), "dense and sparse sketches of one row differ")
    nd = dense.shape[0]
    live = int((dense != 0).sum())
    psi_hits = int(hashing.psi_bits(d_idx, d_val, params.psi_seed).sum())
    record("cabin_build", 0,
           cuda_ms(lambda: dense_ops.cabin_build(dense, **kw), 10),
           cuda_ms(dense_plain, 1),
           # every category read once, every sketch word written
           dense.numel() * 4 + nd * w * 4,
           # a zero test per value, then as B1: 22 per live value (psi)
           # and 14 where psi is 1 (pi and the OR)
           {"int32": dense.numel() + live * 22 + psi_hits * 14})

    # B6: the prefill's first attention call, (4, 32 / 8, 1024, 128) bf16
    # causal; then float32 at batch 1 to the float32 tolerance
    q, k, v = qkv
    b, hq, s, dh = q.shape
    skv, dv = k.shape[2], v.shape[3]
    got = flash_ops.flash_attention(q, k, v, causal=True)
    want = flash_ops.attention_ref(q, k, v, causal=True)
    ratio = flash_ops.tolerance_ratio(got, want)
    err = float((got.float() - want.float()).abs().max())
    check(ratio <= 1.0, f"flash_attention bf16: {ratio} x the tolerance")
    q32, k32, v32 = (t[:1].float().contiguous() for t in (q, k, v))
    got32 = flash_ops.flash_attention(q32, k32, v32, causal=True)
    want32 = flash_ops.attention_ref(q32, k32, v32, causal=True)
    ratio32 = flash_ops.tolerance_ratio(got32, want32)
    err32 = float((got32 - want32).abs().max())
    check(ratio32 <= 1.0, f"flash_attention f32: {ratio32} x the tolerance")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_err = float((sdpa(q, k, v, is_causal=True, enable_gqa=True).float()
                     - want.float()).abs().max())
    f32_ms = cuda_ms(lambda: flash_ops.flash_attention(
        q32, k32, v32, causal=True), 5)
    log(f"[kernel:flash_attention:f32] (1, {hq}, {s}, {dh}) float32: "
        f"max_abs_err {err32} ({ratio32:.4f} x the tolerance 1e-5), kernel "
        f"{f32_ms:.4f} ms; bf16 at the main shape {ratio:.4f} x its "
        f"tolerance; SDPA against the plain version: max |diff| {lib_err}")
    elem = q.element_size()
    flash_runs = [cuda_ms(lambda: flash_ops.flash_attention(
        q, k, v, causal=True), 10) for _ in range(TIMED_RUNS)]
    sdpa_runs = [cuda_ms(lambda: sdpa(q, k, v, is_causal=True,
                                      enable_gqa=True), 10)
                 for _ in range(TIMED_RUNS)]
    flops = 4 * b * hq * s * skv * dh * 0.5  # QK^T, PV; causal half
    log(f"[kernel:flash_attention:bf16] ({b}, {hq} / {k.shape[1]}, {s}, "
        f"{dh}) causal, {TIMED_RUNS} runs of 10 launches: kernel "
        f"{flash_runs} ms, SDPA {sdpa_runs} ms; kernel median "
        f"{flops / float(np.median(flash_runs)) / 1e9:.1f} TFLOP/s")
    record("flash_attention", err, float(np.median(flash_runs)),
           cuda_ms(lambda: flash_ops.attention_ref(q, k, v, causal=True), 3),
           (q.numel() + k.numel() + v.numel() + b * hq * s * dv) * elem,
           # QK^T and PV, 2 flops per multiply-add, half of them causal
           {"bf16": flops},
           library_ms=float(np.median(sdpa_runs)),
           tolerance="2 bf16 ulps of each row's largest |value|",
           tolerance_ratio=ratio, ms_runs=flash_runs,
           library_ms_runs=sdpa_runs, f32_max_abs_err=err32,
           f32_tolerance_ratio=ratio32, f32_ms=f32_ms, sass=sass)

    # Checks beyond the main shapes come after every main-shape timing, so
    # that none of them runs just before a timing it could disturb.
    # B1 and B5 above the shared-memory bitmap: the device-memory path
    big = dict(kw, d=BIG_D)
    bi, bv = idx[:BIG_D_ROWS].contiguous(), val[:BIG_D_ROWS].contiguous()
    bx = dense[:BIG_D_ROWS].contiguous()
    for name, kernel, plain in (
            ("cabin_build_sparse", lambda: sparse_ops.cabin_build_sparse(
                bi, bv, **big),
             lambda: sparse_ops.cabin_build_sparse_ref(bi, bv, **big)),
            ("cabin_build", lambda: dense_ops.cabin_build(bx, **big),
             lambda: dense_ops.cabin_build_ref(bx, **big))):
        got = kernel()
        check(got.shape == (BIG_D_ROWS, (BIG_D + 31) // 32)
              and torch.equal(got, plain()),
              f"{name} != plain version at d = {BIG_D}")
        del got
        log(f"[kernel:{name}:d={BIG_D}] {BIG_D_ROWS} rows above the "
            f"shared-memory bitmap (d > {sparse_ops.MAX_D}): bit-identical "
            f"to the plain version, kernel {cuda_ms(kernel, 5):.4f} ms")

    # B2 at k = 1,024 (into B2's entry): 16 queries in one pass
    for metric in ("cham", "hamming"):
        qs = runs[metric]["q_sk"]
        st = runs[metric]["alive"]
        qb = qs[:BIG_K_QUERIES].contiguous()
        before = build.LAUNCHES["topk_select"]
        gv, gi = topk_ops.topk_select(qb, st, BIG_K, d=SKETCH_DIM,
                                      metric=metric)
        passes = build.LAUNCHES["topk_select"] - before
        wv, wi = topk_ops.topk_select_ref(qb, st, BIG_K, d=SKETCH_DIM,
                                          metric=metric)
        check(torch.equal(gi, wi) and torch.equal(gv, wv),
              f"topk_select != plain at k = {BIG_K} ({metric})")
        check(passes == 1, f"topk_select at k = {BIG_K} took {passes} "
              f"passes, not one")
        big_ms = cuda_ms(lambda: topk_ops.topk_select(
            qb, st, BIG_K, d=SKETCH_DIM, metric=metric), 3)
        one_ms = cuda_ms(lambda: topk_ops.topk_select(
            qb, st, K, d=SKETCH_DIM, metric=metric), 3)
        big_bound, _ = bound(topk_bytes(BIG_K_QUERIES, st.shape[0], w, BIG_K),
                             topk_ops_needed(BIG_K_QUERIES, st.shape[0], w),
                             rates)
        big_plan = topk_ops.plan(BIG_K_QUERIES, st.shape[0], BIG_K, w, sms)
        big_k[metric] = {"queries": BIG_K_QUERIES, "rows": st.shape[0],
                         "k": BIG_K, "passes": passes, "ms": big_ms,
                         "bound_ms": big_bound, f"ms_k{K}": one_ms,
                         "plan": big_plan._asdict()}
        log(f"[kernel:topk_select:{metric}:k={BIG_K}] {BIG_K_QUERIES} "
            f"queries x {st.shape[0]} rows, plan {big_plan}: bit-identical "
            f"to the plain version in {passes} pass, kernel {big_ms:.4f} ms, "
            f"bound {big_bound:.4f} ms (k={K}: {one_ms:.4f} ms)")

    # B1-B4 at the width the lifecycle phase migrated to (W = 174 for
    # these rows: not a multiple of 4, so B2 and B3 take their 4-byte
    # copies), bit for bit
    life = runs["lifecycle"]
    d_new, kw_new = life["d"], life["kw"]
    w_new = packing.packed_width(d_new)
    st, qs = life["alive"], life["q_sk"]
    m_new = st.shape[0]
    migrated = {}

    def at_width(name, kernel, plain, n_bytes, ops, shape, plain_reps=1,
                 into=migrated, d=d_new):
        ms = [cuda_ms(kernel, 10) for _ in range(TIMED_RUNS)]
        p_ms = cuda_ms(plain, plain_reps, warmup=0)
        b_ms, b_by = bound(n_bytes, ops, rates)
        into[name] = {"d": d, "w": packing.packed_width(d), "shape": shape,
                      "max_abs_err": 0, "ms": float(np.median(ms)),
                      "ms_runs": ms, "plain_ms": p_ms, "bound_ms": b_ms,
                      "bound_by": b_by}
        log(f"[kernel:{name}:d={d}] {shape}: bit-identical to the plain "
            f"version, kernel {TIMED_RUNS} runs {ms} ms (median "
            f"{float(np.median(ms)):.4f} ms), plain {p_ms:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}: {n_bytes:.0f} bytes, operations {ops})")

    got = sparse_ops.cabin_build_sparse(ci, cv, **kw_new)
    check(torch.equal(got,
                      sparse_ops.cabin_build_sparse_ref(ci, cv, **kw_new)),
          f"cabin_build_sparse != plain version at d = {d_new}")
    live = int((cv != 0).sum())
    psi_hits = int(hashing.psi_bits(ci, cv, kw_new["psi_seed"]).sum())
    at_width("cabin_build_sparse",
             lambda: sparse_ops.cabin_build_sparse(ci, cv, **kw_new),
             lambda: sparse_ops.cabin_build_sparse_ref(ci, cv, **kw_new),
             (ci.numel() + live) * 4 + CHUNK * w_new * 4,
             {"int32": live * 22 + psi_hits * 14},
             f"{CHUNK} x {M_SLOTS} slots -> ({CHUNK}, {w_new})")
    check(torch.equal(hamming_ops.row_popcount(st),
                      hamming_ops.row_popcount_ref(st)),
          f"row_popcount != plain version at d = {d_new}")
    at_width("row_popcount", lambda: hamming_ops.row_popcount(st),
             lambda: hamming_ops.row_popcount_ref(st),
             m_new * w_new * 4 + m_new * 4,
             {"int32": m_new * w_new, "popc": m_new * w_new},
             f"({m_new}, {w_new})")
    qa, rows = qs[:N_RADIUS_QUERIES].contiguous(), st[:65536].contiguous()
    gi, gh = hamming_ops.pair_stats(qa, rows)
    wi, wh = hamming_ops.pair_stats_ref(qa, rows)
    check(torch.equal(gi, wi) and torch.equal(gh, wh)
          and torch.equal(hamming_ops.pair_stats(qa, rows, op_ham=False)[0],
                          wi),
          f"pair_stats != plain version at d = {d_new}")
    mq, nr = qa.shape[0], rows.shape[0]
    at_width("pair_stats",
             lambda: hamming_ops.pair_stats(qa, rows, op_ham=False),
             lambda: hamming_ops.pair_stats_ref(qa, rows, op_ham=False),
             (mq + nr) * w_new * 4 + mq * nr * 4,
             pair_ops_needed(mq, nr, w_new),
             f"{mq} x {nr} x {w_new} words, inner only")
    for metric in ("cham", "hamming"):
        gv, gi = topk_ops.topk_select(qs, st, K, d=d_new, metric=metric)
        wv, wi = topk_ops.topk_select_ref(qs, st, K, d=d_new, metric=metric)
        check(torch.equal(gi, wi) and torch.equal(gv, wv),
              f"topk_select != plain version at d = {d_new} ({metric})")
    nq = qs.shape[0]
    at_width("topk_select",
             lambda: topk_ops.topk_select(qs, st, K, d=d_new),
             lambda: topk_ops.topk_select_ref(qs, st, K, d=d_new),
             topk_bytes(nq, m_new, w_new, K),
             topk_ops_needed(nq, m_new, w_new),
             f"{nq} queries x {m_new} rows, k={K}, plan "
             f"{topk_ops.plan(nq, m_new, K, w_new, sms)}")

    # B1-B4 at the corpus phase's width (d = theory.sketch_dim(p95 distinct
    # tokens a document): W = 412 for these documents), bit for bit
    corpus = runs["corpus"]
    d_c, pc = corpus["d"], corpus["params"]
    w_c = packing.packed_width(d_c)
    kw_c = dict(d=d_c, psi_seed=pc.psi_seed, pi_seed=pc.pi_seed)
    wide: dict = {}
    c_idx, c_val = corpus["window"]
    check(torch.equal(sparse_ops.cabin_build_sparse(c_idx, c_val, **kw_c),
                      sparse_ops.cabin_build_sparse_ref(c_idx, c_val, **kw_c)),
          f"cabin_build_sparse != plain version at d = {d_c}")
    live = int((c_val != 0).sum())
    psi_hits = int(hashing.psi_bits(c_idx, c_val, pc.psi_seed).sum())
    nw = c_idx.shape[0]
    at_width("cabin_build_sparse",
             lambda: sparse_ops.cabin_build_sparse(c_idx, c_val, **kw_c),
             lambda: sparse_ops.cabin_build_sparse_ref(c_idx, c_val, **kw_c),
             (c_idx.numel() + live) * 4 + nw * w_c * 4,
             {"int32": live * 22 + psi_hits * 14},
             f"one window, {nw} documents x {c_idx.shape[1]} slots -> "
             f"({nw}, {w_c})", into=wide, d=d_c)
    st_c, qs_c = corpus["alive"], corpus["q_sk"]
    m_c = st_c.shape[0]
    check(torch.equal(hamming_ops.row_popcount(st_c),
                      hamming_ops.row_popcount_ref(st_c)),
          f"row_popcount != plain version at d = {d_c}")
    at_width("row_popcount", lambda: hamming_ops.row_popcount(st_c),
             lambda: hamming_ops.row_popcount_ref(st_c),
             m_c * w_c * 4 + m_c * 4,
             {"int32": m_c * w_c, "popc": m_c * w_c},
             f"the corpus, ({m_c}, {w_c})", into=wide, d=d_c)
    blk, strip = corpus["strip"]
    gi, gh = hamming_ops.pair_stats(blk, strip)
    wi, wh = hamming_ops.pair_stats_ref(blk, strip)
    check(torch.equal(gi, wi) and torch.equal(gh, wh)
          and torch.equal(hamming_ops.pair_stats(blk, strip, op_ham=False)[0],
                          wi),
          f"pair_stats != plain version at d = {d_c}")
    mq, nr = blk.shape[0], strip.shape[0]
    at_width("pair_stats",
             lambda: hamming_ops.pair_stats(blk, strip, op_ham=False),
             lambda: hamming_ops.pair_stats_ref(blk, strip, op_ham=False),
             (mq + nr) * w_c * 4 + mq * nr * 4,
             pair_ops_needed(mq, nr, w_c),
             f"the corpus dedup's widest banded strip, {mq} x {nr} x {w_c} "
             "words, inner only", into=wide, d=d_c)
    for metric in ("cham", "hamming"):
        gv, gi = topk_ops.topk_select(qs_c, st_c, K, d=d_c, metric=metric)
        wv, wi = topk_ops.topk_select_ref(qs_c, st_c, K, d=d_c, metric=metric)
        check(torch.equal(gi, wi) and torch.equal(gv, wv),
              f"topk_select != plain version at d = {d_c} ({metric})")
    nq = qs_c.shape[0]
    at_width("topk_select",
             lambda: topk_ops.topk_select(qs_c, st_c, K, d=d_c),
             lambda: topk_ops.topk_select_ref(qs_c, st_c, K, d=d_c),
             topk_bytes(nq, m_c, w_c, K),
             topk_ops_needed(nq, m_c, w_c),
             f"{nq} kept documents x the bulk engine's {m_c} rows, k={K}, "
             f"plan {topk_ops.plan(nq, m_c, K, w_c, sms)}", into=wide,
             d=d_c)
    for entry in out:
        if entry["name"] in migrated:
            entry["migrated_width"] = migrated[entry["name"]]
        if entry["name"] in wide:
            entry["corpus_width"] = wide[entry["name"]]
    return out


def smoke(seed: int, device=torch.device("cuda")) -> None:
    card = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[device] {name} x{torch.cuda.device_count()}, torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}; TF32 off for "
        f"matmul and cuDNN")
    log(f"[device] nvidia-smi: {card}")

    t0 = time.perf_counter()
    paths = build.build()
    log(f"[build] {len(paths)} libraries in {time.perf_counter() - t0:.1f}s "
        f"({', '.join(p.name for p in paths.values())})")
    sass = flash_sass(paths["flash_attention"])
    usage = {
        "topk_select": check_res_usage(
            paths["topk_select"], "topk_split_kernel", "BQ, CAP, cham", 10,
            ("IMMA",)),
        "pair_stats": check_res_usage(
            paths["hamming"], "pair_stats_kernel", "inner, hamming", 3,
            ("IGMMA", "IMMA")),
        "cabin_build_sparse": check_res_usage(
            paths["cabin_build_sparse"], "cabin_sparse_kernel",
            "slots a load, bitmap in device memory", 6)}

    smoke_phases(seed, device, card, name, sass, usage)


def smoke_phases(seed: int, device, card: str, name: str, sass: dict,
                 usage: dict) -> None:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    t0 = time.perf_counter()
    idx, val = pubmed_rows(N_ROWS, gen, device)
    q_idx, q_val = pubmed_rows(N_TOPK_QUERIES, gen, device)
    d_idx, d_val = pubmed_rows(N_DENSE, gen, device)
    dense = dense_rows(d_idx, d_val)
    torch.cuda.synchronize()
    nnz = (val != 0).sum(1).float()
    log(f"[data] {N_ROWS} rows x {M_SLOTS} slots and {N_DENSE} dense rows x "
        f"{N_DIMS} in {time.perf_counter() - t0:.1f}s, nnz mean "
        f"{nnz.mean().item():.2f} min {int(nnz.min())} max "
        f"{int(nnz.max())}; dense nnz mean "
        f"{(dense != 0).sum(1).float().mean().item():.2f}")

    rng = np.random.default_rng(seed)
    build.reset_launches()
    runs = {m: main_path(m, idx, val, dense, q_idx, q_val, rng, card)
            for m in ("cham", "hamming")}
    launches = dict(build.LAUNCHES)
    log(f"[main] kernel launches: {launches}")
    for kernel in INDEX_KERNELS:
        check(launches[kernel] > 0,
              f"kernel {kernel} was not launched on the index path")
    log(f"[main] peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    batches = [pubmed_rows(N_TOPK_QUERIES, gen, device)
               for _ in range(TIMED_RUNS)]
    for m in ("cham", "hamming"):
        runs[m]["topk_rates"] = time_topk(m, runs[m], batches, card)
    served = frontdoor_phase(
        runs["cham"], gen, {"topk": 1 + TIMED_RUNS, "radius": 1,
                            "pairwise": 1}, card)
    clustered = cluster_phase(runs["cham"], gen, rng, seed, card)
    for m in ("cham", "hamming"):
        del runs[m]["engine"]
    runs["dense_coo"] = (d_idx, d_val)
    runs["lifecycle"] = lifecycle_phase(idx, val, gen, rng, card)
    runs["corpus"] = corpus_phase(seed, card, device)

    rates = peak_rates()
    # the paper phase's rows are drawn on the host in worker processes,
    # started only now so that no phase before shares the host's cores
    # with them while it takes its readings; they end with the phase
    with multiprocessing.get_context("spawn").Pool(PAPER_WORKERS) as pool:
        papered = paper_phase(start_paper_samples(pool, seed), card, rates,
                              device)
    torch.cuda.empty_cache()

    qkv, lm_launches, hashed = lm_phase(seed, card)
    launches["flash_attention"] = lm_launches["flash_attention"]
    torch.cuda.empty_cache()

    kernels = kernel_phases(CabinParams.create(N_DIMS, SKETCH_DIM, seed=0),
                            idx, val, dense, runs, qkv, launches, rates,
                            sass, usage)
    for entry in kernels:
        entry["frontdoor_launches"] = served["launches"][entry["name"]]
        entry["lifecycle_launches"] = runs["lifecycle"]["launches"][
            entry["name"]]
        entry["cluster_launches"] = clustered["launches"][entry["name"]]
        entry["corpus_launches"] = runs["corpus"]["launches"][entry["name"]]
        entry["paper_launches"] = papered["launches"][entry["name"]]
        entry["cabinembed_launches"] = hashed["launches"][entry["name"]]
        if entry["name"] in papered["widest"]:
            entry["paper_width"] = papered["widest"][entry["name"]]
    print(json.dumps({"lifecycle": runs["lifecycle"]["record"],
                      "cluster": clustered["record"],
                      "corpus": runs["corpus"]["record"],
                      "paper": paper_summary(papered["record"]),
                      "cabinembed": hashed["record"]}))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    smoke(args.seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
