#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU, end to end.

    python3 chip_smoke.py            # needs one CUDA device

What it does, one JSON line per phase:

1. ``device``: the card's name and power limit (``nvidia-smi``), torch and
   CUDA versions.
2. ``build``: compiles ``src/repro_torch/csrc/*.cu`` with ``nvcc`` into
   ``build/`` (this is the first use of the kernels) and reports the seconds.
3. ``kernels``: calls each hand-written kernel's wrapper on the paper
   matrix's own arrays and holds it against its plain PyTorch version on the
   same inputs, with variants (weighted values, bf16 input, ragged shapes, a
   block whose slots are all padding; for ``topk_score``: f32, int8 with
   kvquant scales, a valid width with an index offset, a ragged last tile and
   three-way ties, at the paper universe and at 256 x 1,048,576, compared
   with ``torch.equal``; ``sparse_gram`` against a float64 sum -- exactly
   on 0/1 data -- and the same bits over 10 calls, on the weighted paper
   matrix, a ragged case with duplicates and an all-padding block, a row
   longer than one sorted piece, K = 36, M = 33 and M above the row chunk;
   ``sketch_panel`` at L = 24, 41 and 64, K = 36 and 1,300, Omega in
   either contiguous layout and in neither, the same bits over 10 calls
   and one device kernel a call where Omega is contiguous).  Times kernel,
   plain version and, where one PyTorch
   call computes the same function, that call, and works out the least time
   the card could take (``bound_ms``) and the rates the kernel's time stands
   for (``achieved_tflops``, ``achieved_gb_s``), and counts the device
   kernels one call of each wrapper launches (``device_kernels``, from
   ``torch.profiler``; ``launches`` counts wrapper calls); ``topk_score``'s two passes
   are also timed apart (``pass_ms``, ``torch.profiler``),
   ``flash_attention`` is timed beside SDPA at the long prompt (2, 32, 3000,
   80), at head dim 128 and at gemma2-9b's widths (8, 16/8, 1024, 256, with
   window, softcap, ragged, right-aligned and keyless-row variants at head
   dim 256) too, and ``ssd_scan`` at the long prompt x (2, 3000, 80, 64) and
   at mamba2-1.3b's widths x (8, 1024, 64, 64), N 128 beside the prefill
   shape, with variants L = 1 and L = 11 (a chunk shorter than one 16-row
   MMA tile), G = 2, G = H = 8, ragged L = 1000, P = N = 16, P = N = 128
   and a decaying state, in bf16 and float32.  ``blockgram`` is held against a
   float64 sum at the dense solve's shape on the paper matrix (exactly), on
   gaussian float32 (twice: the same bits), bf16, the weighted paper matrix
   and the values its bf16 split serves worst, and on short, ragged and
   mixed rows, and timed beside ``torch.bmm``.  ``sparse_gram`` is timed
   beside ``torch.sparse.mm`` of the block-diagonal CSR of the stored
   columns by its transpose (cuSPARSE SpGEMM), whose diagonal blocks are
   held to the kernel's grams.  ``right_vectors`` (V = A^T U / S) is held
   to its plain version at 1e-5 of max|V| and to the same bits over 10
   calls on the repaired paper matrix (U square: a row stride of 539
   floats, the scalar path; a column slice of U into a strided, unaligned
   column slice of a wider panel, S rank-deficient) and on a ragged stack
   with two stored columns on one id and an all-padding block, and timed
   beside ``torch.sparse.mm`` of A^T as CSR by U.
4. ``solve_sparse_exact`` / 5. ``solve_dense_exact`` / 6. ``solve_randomized``
   / 7. ``solve_scaled``: ``repro_torch.core.api.svd`` on the paper's
   539 x 170,897 matrix (COO and dense input, exact and rank-16) and on two
   larger matrices, each result held against a float64 (or scipy) reference
   of the repaired matrix; ``sparse_gram`` at (a)'s ELL (0/1 and with
   seeded weights), ``sketch_panel`` at (b)'s (L = 64, K = 36, Omega in
   both layouts) and ``right_vectors`` at (a)'s (the exact cell's shape:
   D 8, W 131,072, U 2,048 x 2,048; and U's first 72 columns into columns
   64 - 135 of a (D*W, 136) panel, as the streaming merges pass it) are
   checked and timed there, under the ``kernels`` line's
   ``timed_variants``.  Every kernel's launch counter is set to 0 just
   before each solve and read just after it; the counts are kept solve by
   solve and never added up across solves.  Stage times come from the
   solver's obs spans (``obs.span_summary``; device time between each
   span's two CUDA events) around further warm solves.
8. ``stream_exact``: ``svd_init`` + ``svd_update`` of the paper matrix in 4
   row batches at full rank, held against float64 singular values.
9. ``stream_serve``: the user's configuration: the paper rows in batches of
   64 at rank 16 (held against the same stream on the CPU), served by
   ``serve_init`` / ``serve_topk`` in waves of 32 (f32 and int8; every wave
   equal to the plain version bit for bit), one cold-start wave through
   ``project_rows``, 200 waves with no ingest beside them, then waves
   answered while an ingest thread on its own CUDA stream folds in the
   remaining batches and commits them.
10. ``serve_scaled``: a 1,048,576-item catalogue at rank 64 built by two
   ingests, served in waves of 256 with k_top 100, f32 and int8.
   Phases 8-10 also hold ``sparse_gram`` against its plain version on
   repaired batches that their ingests factor.
10b. ``hierarchical``: the tree merge (``backend="hierarchical"``, D = 8,
   fanout 4) on the paper matrix exact from COO (one ``sparse_gram``, one
   ``right_vectors``) and dense input (one ``blockgram``), with right
   vectors, against float64;
   the same at rank 16 against the same solve on the CPU; rule R2
   (``sketch=True``, rank 16) on phase 7b's 32,768 x 262,144 matrix (one
   ``sketch_panel`` a pass over the whole block stack), never above the
   truth and against the CPU; the wide group panels' orthogonality under
   both cuSOLVER drivers.
10c. ``stream_window``: ``svd_stream`` (rule R6) on a 1,048,576-item
   catalogue at rank 64 (48 ELL batches of 1,000-1,024 rows after the
   rank-growth batch) and on the paper's rows in dense batches of 50-64
   rows at rank 16: ``window`` auto against ``window=1`` (``torch.equal``)
   and against an ``svd_update`` loop (1e-3 * S[0]); ms per batch in each
   mode, the host syncs of a window and of its batches one by one (torch's
   sync debug mode), one window's measured peak against R6's closed form
   (must not exceed it), and the kernels on a padded bucket against the
   batch as it is (the same bits; times side by side).
11. ``merge_driver_ab``: the streams of phases 8 and 9 on three seeds under
   each cuSOLVER driver of the merge SVD, orthogonality and time.
12. ``lm_serve``: LM serving of zamba2-2.7b at full width (54 Mamba-2
   layers, d_model 2560, one shared attention block applied 9 times),
   weights drawn from a seeded generator on the card: (a) ``prefill_forward``
   of 8 prompts of 1,024 tokens in bf16 (``flash_attention`` launched 9
   times and ``ssd_scan`` 54 times, checked exactly), then 32 greedy
   ``decode_step``s, and a long prefill of 2 prompts of 3,000 tokens
   (the same launch counts: every length goes to the kernels); (b) in a
   float32 copy of the config, the kernels held inside the model:
   ``prefill_forward`` of 2 x 256 tokens against ``engine.prefill_cache``
   (decode steps, no kernel) of the same prompt, last logits and every
   cache entry, and a control (the kernels fed bf16-rounded inputs) that
   must exceed the same limit; (c) ``engine.generate`` of 4 short requests
   x 32 tokens, greedy and sampled from a seeded generator.
   Phase 3 holds ``flash_attention`` and ``ssd_scan`` against their plain
   versions at this path's shapes, in bf16 and float32, with variants.
12b. ``lm_families``: the ssm, dense and vlm families, weights from a
   seeded generator on the card, one line per model.  (a) gemma2-9b at full
   width and depth (42 layers, 37 GB of float32 weights): ``prefill_forward``
   of 2 x 8,192 tokens, past the window of 4,096 (``flash_attention``
   exactly 42 launches, ``ssd_scan`` none), 32 greedy decode steps, then
   32 teacher-forced steps at B = 8 with the int8 KV cache against a float
   one: in float32 against the float32 cache at the reference's
   ``tests/test_kvquant.py`` limits (its own setting), and in the config's
   bf16 against the bf16 cache (greedy agreement held, the excess over the
   same limits recorded), and the caches' bytes; (b) its first 4 layers in float32 on a prompt of 4,160 tokens:
   ``prefill_forward`` (4 launches, the window hiding the first 64 keys
   from the last rows) against ``engine.prefill_cache`` (decode steps, no
   kernel), last logits and every K / V entry within 3e-4 of max, and
   the same prefill with ``attn_window=0`` as the control that must exceed
   it.  (c) mamba2-1.3b (48 layers): 8 x 1,024 in bf16 (``ssd_scan``
   exactly 48), 32 decode steps, the float32 check at 2 x 256 with the
   bf16-rounded control.  (d) qwen2-vl-2b (28 layers): 8 x 1,024 with three
   position streams (a 16 x 16 image block at tokens 8-263, then text;
   ``flash_attention`` exactly 28), 32 decode steps with the engine's
   positions, the float32 check on text.  (e) phi3-medium-14b,
   phi4-mini-3.8b and starcoder2-15b at full width and 2 layers: 2 x 1,024
   (2 launches each), 8 decode steps, the float32 check at 1 x 128.
   Phase 3 holds ``flash_attention`` at gemma2-9b's prefill shape (window
   4,096, softcap 50, B 1 against the plain version, timed at B 2 beside
   SDPA with a band mask) and at starcoder2's GQA group of 12.
12c. ``lm_moe_encdec``: the moe and encdec families, weights from a seeded
   generator on the card, one line per model, every earlier model freed
   first.  (f) phi3.5-moe-42b-a6.6b at full width (16 experts top-2, d_ff
   6,400), cut to 8 layers: ``prefill_forward`` of 8 x 1,024 in bf16
   (``flash_attention`` exactly 8), 32 greedy decode steps, the share of
   (token, k) pairs dropped at the default capacity factor 1.25 (prefill
   and decode, the latter routing B tokens a step); the int8 KV cache
   against a float one at B 8 over 32 teacher-forced steps at the
   reference's capacity factor 8.0, in float32 at ``tests/test_kvquant.py``'s
   limits and in bf16 (agreement held, the excess recorded); the float32
   check of ``prefill_forward`` against ``engine.prefill_cache`` at 2 x 256
   with the no-drop factor E / K (no pair dropped), control: bf16-rounded
   kernel inputs.  (g) qwen3-moe-235b-a22b at full width (128 experts
   top-8), cut to 4 layers: 2 x 1,024 (4 launches), 8 decode steps, drop
   shares, the float32 check at 1 x 128 with factor 16.  (h) whisper-small
   at full width and depth (12 + 12 layers, 1,500 frames of seeded random
   embeddings): ``prefill_forward`` of 8 x 448 tokens (36 launches: 12
   encoder, 12 self, 12 cross), 32 decode steps through ``engine.step``
   over the prefill's cross cache, the float32 check at 2 x 64 against
   ``engine.prefill_cache(frames=)`` on logits and the ``k``, ``v``,
   ``xk``, ``xv`` entries.  Phase 3 holds ``flash_attention`` at whisper's
   shapes: the encoder (8, 12, 1,500, 64) non-causal, the cross-attention
   (8, 12, 448, 64) over 1,500 keys and (1, 12, 2,048, 64) over 1,500 keys
   (sq > sk), bf16 and float32, beside the bound and SDPA.  At every
   ``flash_attention`` case phase 3 also asks the kernel for its row
   log-sum-exp (the training forward's second output): the output must be
   the same bits, and lse within 1e-5 (float32) / 1e-3 (bf16) of max|lse|
   of the plain version's, -inf exactly on the rows that see no key.
12d. ``lm_train``: training, one JSON line a case.  (a) zamba2-2.7b at
   full width cut to 12 layers (2 shared-block groups), float32, 2 x 256
   tokens: every parameter leaf's gradient of ``train_loss`` through the
   kernels (``flash_attention`` 2, ``ssd_scan`` 12 launches) against
   autograd of the plain versions called directly, per leaf max|d| <= 1e-3
   x max|g|, every leaf non-zero, and a control (bf16-rounded kernel
   inputs) that must exceed the limit; the flash backward alone against
   autograd of the plain version at gemma2-9b's local layer past its window
   (1 x 16/8 x 5,120, head dim 256, softcap 50) and at whisper's 448
   queries over 1,500 keys, float32 (1e-4 of max) and bf16 (1e-2: the saved
   output is bf16); both backwards (torch ops, not kernels) timed at
   zamba2's training shape beside their bounds, the plain versions'
   autograd and SDPA's backward.  (b) zamba2-2.7b at full depth, bf16 over
   float32 master weights, AdamW, remat ``"dots"``, the launcher's 8 x 512
   tokens from ``batch_at``: 6 steps (finite metrics, ``flash_attention``
   exactly 18 and ``ssd_scan`` 108 launches a step: forward and the
   remat's recompute), ms a step, tokens/s, peak bytes, then one step
   timed by part (CUDA events around the gradient, the two backwards and
   AdamW) and one profiled (device time by kernel category).  (c)
   Ranky-GaLore on examples/gradient_compression_torch.py's model in
   float32, 2 steps from one set of parameters on the card and on the CPU
   (repair columns drawn on the CPU on both sides): the bases after the
   refresh compared after a sign fix beside their eigenvalue gaps, the
   CPU's bases carried over, parameters per leaf within 1e-4 of max; the
   refresh's ms, the state's bytes against AdamW's.  (d) the loop on
   zamba2's smoke config, 5 + 5 steps with a restart against 10 straight
   (rtol 1e-4, atol 1e-5; whether the bits are equal is recorded).
13. ``checkpoint``: the paper rows' sparse stream at rank 16
   (``use_kernel=True``) saved with ``repro_torch.checkpoint`` and restored
   onto the card; u, s, v equal (``torch.equal``) and the counters too, then
   three more ``svd_update``s from the original and from the restored state
   (the same bits), and a window resumed mid-stream from a restored state
   against the uninterrupted one (the same bits); save and restore ms and
   the file's size.
14. ``observe``: ``svd_stream`` of the paper rows at rank 16 in sparse and
   in dense batches (``use_kernel=True``) plus 20 waves of ``serve_topk``,
   first with obs off, then on: u, s, v and every wave equal
   (``torch.equal``), the same window dispatches, step shapes, kernel
   launches and host syncs a batch (sync debug mode); R5, R6 and R7 drift
   ratios recorded, each within ``obs.gate.drift_factor()``; every span's
   CUDA events resolved, the top-level spans' sum within the wall time, the
   Chrome trace valid; ms a batch with obs off and on.  Then the
   reference's obs-off serving gate: with obs off, interleaved pairs of a
   direct ``ranker.score_topk`` on the handle and ``serve_topk`` (the
   garbage collector off while pairs are timed), each call timed on the
   host clock up to a synchronize, 3 rounds of 120,000 pairs; the least
   p99 of ``serve_topk`` within 1.01 x the least p99 of the direct call.
14b. ``lint``: the analyzer (``repro_torch.analysis``) over
   ``src/repro_torch``: no unsuppressed finding; then every host-sync site
   phase 14 recorded (torch's sync debug mode; a sync inside torch's own
   Python code is put on the port's line that called it), classified
   against rule RL107: outside the port, covered (the line is in a call
   RL107 flags), out of its reach (not serve/ or stream/, or in no host
   loop), or missed (in a hot-path loop body and not flagged: fails).
14c. ``trace``: ``scripts/ranky_trace_torch.py`` as a process, at the
   reference CI's invocation (its defaults, Prometheus metrics) and at the
   paper's column count (24 batches of 64 x 170,897 at rank 16, 32 waves,
   JSON metrics): exit 0, a valid Chrome trace covering the categories
   ingest / merge / serve / snapshot and every span name the reference's
   run writes, metrics that parse and hold the reference's names,
   ``blockgram`` launched by the stream and ``topk_score`` exactly once a
   wave, drift within the factor and no ``DriftWarning``.
15. ``drift_stages``: ``scripts/drift_stages_torch.py`` at the streaming
   example's shapes: the R5 / R6 drift of its first ingests and window, the
   peak bytes of every stage beside the term that prices it, and the
   workspace of the merge's QR at those panels.
16. ``distributed``: the sharded engine.  (a) A ``LocalMesh`` of 8 slots on
   the card: gram, proxy, two-level (pod 2 x model 4), rank 16 and
   right-vector solves of the paper matrix (COO, and dense input), each
   against the single engine with the same seed (1e-5 of S[0]) and against
   float64 at phases 4-7's limits, every kernel once over the D-stack; the
   paper rows streamed sparse and dense (R5d ingest, sharded window: the
   same bits as ``window=1``, S within 1e-3 of the single stream, host
   syncs a batch); 20 sharded waves of 32, each equal to the single-device
   ranker (``topk_score`` once a slot); R5d / R6 / R7 drift against 8 times
   the per-device forms (label ``local``).  (b) 4 ranks over gloo on the
   one card (CUDA tensors), each a process with its own allocator: the
   solve at D = 4 against (a)'s local mesh of 4, and each rank's R5d drift
   for one sharded ingest within the factor; a rank that fails, or ranks
   that pass the deadline, fail the phase.  (c) NCCL at world =
   ``torch.cuda.device_count()`` (1 on one card: a solve and an ingest at
   D = 1 in this process).
16a. ``lm_mesh``: the LM model mesh (``models/layers.ShardCtx``).  (a)
   phi3.5-moe-42b-a6.6b at full width, 2 layers, float32, capacity factor
   8, served expert-parallel on 4 gloo ranks (data 2 x model 2) on the one
   card: a prefill of 4 x 128 tokens and 8 teacher-forced decode steps,
   the logits gathered over the vocab against one device's (rtol / atol
   1e-3, the reference test's), every routing compared (a flipped one
   reported, then the logits held with one device's routing pinned), the
   greedy and sampled (``engine.generate``) tokens equal to one device's
   rows and across a data shard's ranks; (b) zamba2-2.7b at full width, 6
   layers, float32, AdamW with ZeRO-1 moments at the full lr from the
   first step, remat ``dots``, 4 x 512 on the same ranks: the first
   batch's gradients within 1e-4 of each leaf's max of one device's, every
   leaf with a gradient; one ZeRO-1 update with one device's gradients,
   every parameter block within rtol 2e-4 / atol 1e-5 of one device's
   update (which moves every leaf past 10 x atol); 2 steps, each loss
   within 1e-4, each leaf's params within 1e-3 of the norm of one device's
   change (``LM_MESH`` says why not elementwise); flash 2 and ssd 12
   launches a step exactly; ms a step, peak by rank; (c) zamba2 at 6
   layers, one request, a cache of 8,192 positions over data 2 on 2
   ranks, 4 decode steps across the slabs' boundary against the unsharded
   decode (1e-3), only the owning slab written; (d) a (1, 1)
   ``ProcessGroupMesh`` over NCCL in this process: (a) and (b) bit for
   bit against the path without a mesh; (e) GaLore over the mesh:
   zamba2-2.7b at full width, 2 layers with the shared block, float32,
   rank 32 refreshed every step, no warmup, on the 4 ranks: one device's
   gradients cut to the blocks give each leaf's gram within 1e-5 of its
   max of one device's and the same lonely-row masks, and one update with
   one device's bases every parameter within rtol 2e-4 / atol 1e-5; then
   2 steps of ``make_train_step``: the bases the same bits on every rank,
   flash 2 and ssd 4 launches a step as one device's, ms a step, GaLore's
   apply ms and peak by rank; a (1, 1) NCCL mesh's GaLore step bit for
   bit against one device's.  A rank that fails or passes the deadline
   fails the phase.
16a'. ``launch``: the dry run's cost counter (``launch/hlocost.py``) on
   ``meta`` prices the zamba2-2.7b train step of ``lm_train`` (b) (on the
   host mesh (1, 1)) and the gemma2-9b prefill of ``lm_families``: the
   bound max(t_compute, t_memory) of ``launch/roofline.py``'s H100 model
   beside the measured time, and not above it; then ``dryrun.run_cell``
   of phi4-mini ``train_4k`` on the 16 x 16 counting mesh.
16b. ``ft``: fault tolerance on the paper rows (sparse batches of 64, rank
   16) over a ``LocalMesh`` of 8 slots: the unfaulted supervised stream
   against the same chunks of ``svd_stream`` (the same bits, one
   ``sparse_gram`` launch or more a committed chunk, the chunks' host syncs
   plus one commit copy a chunk), then the three chaos scenarios of
   ``scripts/chaos_run_torch.py`` (resumed factors ``torch.equal`` to the
   uninterrupted run; Leg B within 1e-5 of S[0] of single-host), recovery
   ms by stage, the replayed chunk's ms, R8's restore transient within the
   drift factor.
17. ``examples``: the nine ``examples/*_torch.py`` twins as subprocesses
   on the card (the streaming and serving twins also with ``--observe``,
   the LM twin at its default mamba2 and on zamba2, the trainers at 60 /
   40 steps): exit code 0, wall seconds, and the kernel launches each one
   reports; every SVD twin must launch its gram kernel with the default
   config (``use_kernel=None`` is the kernel on a CUDA tensor), the LM twin
   ``ssd_scan`` (and on zamba2 ``flash_attention`` too), each trainer
   ``flash_attention`` and a last logged loss below 0.85 x its first.
18. ``stage_summary`` (one ingest, one serve wave), one line
   ``{"kernels": [...]}`` with every kernel's numbers, then the card as
   ``nvidia-smi`` names it, then the last line ``{"ok": true, "device":
   {...}}``.

Without arguments it runs every phase (``--only lm_mesh,...`` runs the
named phases alone, for work on them), exits non-zero at the first phase
that fails, and right away when no CUDA device is present: nothing here runs
on the CPU instead.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

from repro_torch.configs.base import get_config, get_smoke_config  # noqa: E402
from repro_torch.configs.ranky_paper import RankyPaperConfig  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.compression import galore as galore_mod  # noqa: E402
from repro_torch.core import api, hierarchy, ranky, sparse  # noqa: E402
from repro_torch.data import bipartite  # noqa: E402
from repro_torch.data import tokens as data_mod  # noqa: E402
from repro_torch.kernels import blockgram as bg_mod  # noqa: E402
from repro_torch.kernels import build as kernel_build  # noqa: E402
from repro_torch.kernels import flash_attention as fa_mod  # noqa: E402
from repro_torch.kernels import right_vectors as rv_mod  # noqa: E402
from repro_torch.kernels import ops as kernel_ops  # noqa: E402
from repro_torch.kernels import sketch_panel as sp_mod  # noqa: E402
from repro_torch.kernels import sparse_gram as sg_mod  # noqa: E402
from repro_torch.kernels import ssd_scan as ss_mod  # noqa: E402
from repro_torch.kernels import topk_score as tk_mod  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models.layers import ShardCtx  # noqa: E402
from repro_torch.models import schema, transformer  # noqa: E402
from repro_torch.optim import adamw as adamw_mod  # noqa: E402
from repro_torch.optim import schedule as schedule_mod  # noqa: E402
from repro_torch.optim import tree as ptree  # noqa: E402
from repro_torch.serve import engine, kvquant, ranker  # noqa: E402
from repro_torch.stream import state as stream_state  # noqa: E402
from repro_torch.train import loop as train_loop  # noqa: E402
from repro_torch.train import step as train_step  # noqa: E402

# Published peaks of one H100 SXM (NVIDIA's data sheet): device memory rate,
# float32 rate outside the tensor cores and the dense bf16 tensor-core rate.
# bound_ms is stated against them, by the type of the kernel's inputs.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12

NUM_BLOCKS = 8
DEVICE = "cuda"
ROOT = os.path.dirname(os.path.abspath(__file__))
# (M, N) of the two matrices of phase 7; density 5e-4 like the paper's.
SCALED_EXACT = (2048, 1_048_576)
SCALED_TALL = (32_768, 262_144)
# Serving shapes: the paper universe answered in waves of 32 queries at the
# user stream's rank 16, and the scaled catalogue of phase 10.
TOPK_PAPER = dict(b=32, k=16, k_top=10)
STREAM_BATCH_ROWS = 64
SCALED_SERVE = dict(n=1_048_576, rows=1024, batches=2, density=1e-3,
                    rank=64, b=256, k_top=100)
# LM serving (phase 12): zamba2-2.7b at full width; the prefill of the main
# path, a long prefill (s * s above the 2048**2 at which the reference
# leaves its kernel), the float32 check of the kernels inside the model
# (10x its readings, 1.7e-5 - 3.1e-5 of max), the requests.
LM_ARCH = "zamba2-2.7b"
# The configs whose kernel widths phase 3 also holds: mamba2-1.3b's SSM
# state 128 and gemma2-9b's head dim 256 (both served in phase 12b).
SSM_ARCH = "mamba2-1.3b"
WIDE_ATTN_ARCH = "gemma2-9b"
LM_PREFILL = dict(batch=8, seq=1024, decode=32)
LM_LONG = dict(batch=2, seq=3000)
LM_CHECK = dict(batch=2, seq=256, rel=3e-4)
LM_REQUESTS = dict(requests=4, tokens=32, temperature=0.8)
# Phase 12b (``lm_families``): gemma2-9b at full depth, 2 prompts past its
# window of 4,096 (max_seq leaves room for the decode steps), then the int8
# KV cache at B = 8; its first 4 layers in float32 on a prompt 64 tokens
# past the window; mamba2-1.3b and qwen2-vl-2b at full depth (qwen2-vl's
# prompts open with a 16 x 16 image block at tokens 8-263); the other dense
# configs at full width and 2 layers; the float32 checks of mamba2 / qwen2-vl
# (FAMILY_CHECK) and of the cut dense configs (``check_seq``).
GEMMA = dict(arch="gemma2-9b", batch=2, seq=8192, max_seq=8224, decode=32,
             int8_batch=8, int8_steps=32)
GEMMA_CHECK = dict(layers=4, seq=4160)
MAMBA = dict(arch="mamba2-1.3b", batch=8, seq=1024, decode=32)
QWEN = dict(arch="qwen2-vl-2b", batch=8, seq=1024, decode=32, patch=16,
            patch_at=8)
DENSE_CUT = dict(archs=("phi3-medium-14b", "phi4-mini-3.8b",
                        "starcoder2-15b"),
                 layers=2, batch=2, seq=1024, decode=8, check_seq=128)
FAMILY_CHECK = dict(batch=2, seq=256)
# The int8 cache against a float one: the reference's own limits
# (``tests/test_kvquant.py``, float32: rtol 0.1, atol 0.15, greedy
# agreement 0.9; its moe case at capacity factor 8.0).
KV_INT8 = dict(rtol=0.1, atol=0.15, agree=0.9)
KV_INT8_MOE_CF = 8.0
# Phase 12c (``lm_moe_encdec``): the moe configs at full width, cut in
# depth (a phi3.5-moe layer is 1.30e9 parameters, a qwen3-moe layer
# 2.49e9: 41.6 / 39.8 GB of float32 weights at 8 / 4 layers); whisper-small
# at full width and depth, prompts of its published decoder context (448)
# over 1,500 encoder frames; the float32 checks (``check``: batch, tokens).
PHI_MOE = dict(arch="phi3.5-moe-42b-a6.6b", layers=8, batch=8, seq=1024,
               decode=32, int8_batch=8, int8_steps=32, check=(2, 256))
QWEN_MOE = dict(arch="qwen3-moe-235b-a22b", layers=4, batch=2, seq=1024,
                decode=8, check=(1, 128))
WHISPER = dict(arch="whisper-small", batch=8, seq=448, decode=32,
               check=(2, 64))
KERNEL_MODULES = {"sparse_gram": sg_mod, "blockgram": bg_mod,
                  "sketch_panel": sp_mod, "topk_score": tk_mod,
                  "flash_attention": fa_mod, "ssd_scan": ss_mod,
                  "right_vectors": rv_mod}
# ``launches_in``: the solve of the main path whose count is the kernel's
# ``launches`` (the first solve that should reach it).  The counts of every
# solve stand beside it under ``launches_by_solve``.
KERNEL_INFO = {
    "sparse_gram": dict(route="cuda",
                        source="src/repro_torch/csrc/sparse_gram.cu",
                        replaces="src/repro/kernels/sparse_gram.py:76",
                        launches_in="solve_sparse_exact[gram]"),
    "blockgram": dict(route="cuda",
                      source="src/repro_torch/csrc/blockgram.cu",
                      replaces="src/repro/kernels/blockgram.py:59",
                      launches_in="solve_dense_exact"),
    "sketch_panel": dict(route="cuda",
                         source="src/repro_torch/csrc/sketch_panel.cu",
                         replaces="src/repro/kernels/sketch_panel.py:82",
                         launches_in="solve_randomized[p=8,q=2]"),
    "topk_score": dict(route="cuda",
                       source="src/repro_torch/csrc/topk_score.cu",
                       replaces="src/repro/kernels/topk_score.py:125",
                       launches_in="serve_topk[f32]"),
    "flash_attention": dict(route="cuda",
                            source="src/repro_torch/csrc/flash_attention.cu",
                            replaces="src/repro/kernels/flash_attention.py:125",
                            launches_in="lm_serve[prefill]"),
    "ssd_scan": dict(route="cuda",
                     source="src/repro_torch/csrc/ssd_scan.cu",
                     replaces="src/repro/kernels/ssd_scan.py:112",
                     launches_in="lm_serve[prefill]"),
    "right_vectors": dict(route="cuda",
                          source="src/repro_torch/csrc/right_vectors.cu",
                          replaces="no TPU kernel: src/repro/core/svd.py:195 "
                                   "computes it as a jnp product",
                          launches_in="solve_sparse_exact[gram]"),
}


class SmokeFailure(Exception):
    """A phase did not hold; the run ends with a non-zero exit code."""


def check(cond, what: str) -> None:
    if not bool(cond):
        raise SmokeFailure(what)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[torch.cuda.current_device()]


# ---------------------------------------------------------------------------
# Timing and bounds
# ---------------------------------------------------------------------------

_flush_buf = None


def flush_l2() -> None:
    """Overwrite 128 MB so the next launch finds the 50 MB L2 cold, as the
    solver does (its inputs were produced by other work)."""
    global _flush_buf
    if _flush_buf is None:
        _flush_buf = torch.empty(128 << 20, dtype=torch.uint8, device=DEVICE)
    _flush_buf.zero_()


def time_ms(fn, *, iters: int = 10, warmup: int = 2) -> float:
    """Median device time of ``fn()`` over ``iters`` cold-cache launches."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush_l2()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound(bytes_moved: float, flops: float, peak: float = F32_FLOPS):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate of the inputs' type (float32 unless
    ``peak`` says otherwise)."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sparse_gram_bound(rows, vals, m):
    d = rows.shape[0]
    per_col = (vals != 0).sum(dim=-1).double()
    pairs = float((per_col * per_col).sum())       # what THIS data needs
    nbytes = rows.numel() * 4 + vals.numel() * 4 + d * m * m * 4
    return bound(nbytes, 2.0 * pairs)


def sparse_gram_f64(rows, vals, m):
    """The yardstick of sparse_gram's weighted checks: each block's
    stored-column panel in float64, its gram summed in float64 and rounded
    once (the plain version sums in float32)."""
    out = torch.empty((rows.shape[0], m, m), dtype=torch.float32,
                      device=rows.device)
    for i in range(rows.shape[0]):
        p = torch.zeros((rows.shape[1], m), dtype=torch.float64,
                        device=rows.device)
        p.scatter_add_(1, rows[i].long(), vals[i].double())
        out[i] = (p.T @ p).float()
        del p
    return out


def reweighted(vals, seed):
    """The same slots with seeded weights in (0.5, 2) on the non-zero ones
    (padding stays 0)."""
    gen = torch.Generator(vals.device).manual_seed(seed)
    w = torch.rand(vals.shape, generator=gen, device=vals.device) * 1.5 + 0.5
    return torch.where(vals != 0, w, torch.zeros_like(w))


def check_bit_stable(name, case, first, call, calls: int = 10) -> bool:
    """``calls`` further calls give the same bits as ``first``
    (``torch.equal``); a difference fails the run."""
    for i in range(calls):
        again = call()
        torch.cuda.synchronize()
        check(torch.equal(first, again),
              f"{name}[{case}]: call {i + 2} differs from the first by "
              f"{max_err(first, again)}")
    return True


def cuda_events(fn, iters: int):
    """[(name, count, self device microseconds)] of the device-side events
    of ``iters`` warm calls of ``fn`` (``torch.profiler``).  The profiler can
    drop a call's events; the session is run again (three times at most)
    until every event shows once per call or a whole multiple of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [(ev.key, ev.count,
                   getattr(ev, "self_device_time_total",
                           getattr(ev, "self_cuda_time_total", 0.0)))
                  for ev in prof.key_averages()
                  if ev.device_type == DeviceType.CUDA]
        if events and all(count % iters == 0 for _, count, _ in events):
            break
    return events


def device_kernels_per_call(fn, iters: int = 4):
    """Device kernels (memsets and copies included) that one call of
    ``fn`` launches (``cuda_events`` over ``iters`` warm calls); None where
    the profiler saw no device activity, a fraction where it kept dropping
    events."""
    n = sum(count for _, count, _ in cuda_events(fn, iters))
    return n / iters if n else None


def check_device_kernels(name, case, got, want) -> None:
    """A whole count of device kernels a call must be ``want``; a profiler
    that saw nothing or dropped events (None, a fraction) checks nothing."""
    if got is not None and float(got).is_integer():
        check(got == want, f"{name}[{case}]: {got} device kernels a call, "
              f"want {want}")


def device_ms(fn):
    """Device time of one warm call of ``fn``: its kernels' times summed
    (``device_ms_by_kernel``), without the host's launch latency that an
    event pair around a single call also holds; None where the profiler saw
    no device time."""
    return sum(device_ms_by_kernel(fn).values()) or None


def sparse_gram_case(cases, case, rows, vals, m, *, exact=None,
                     calls: int = 10) -> dict:
    """sparse_gram held to a float64 sum at 1e-5 of max|G| (exactly where
    every value is 0 or 1: ``exact`` None decides from the data) and to its
    plain version at the same limit, and ``calls`` further calls giving the
    same bits.  Returns the case's numbers (``symmetric``: G equal to G^T
    bit for bit; ``max_asymmetry``: max |G - G^T|)."""
    if exact is None:
        exact = bool(((vals == 0) | (vals == 1)).all())
    got = sg_mod.sparse_gram(rows, vals, m)
    want = sparse_gram_f64(rows, vals, m)
    rel = 0.0 if exact else 1e-5
    err = compare("sparse_gram", got, want, rel, cases,
                  f"{case}, against a float64 sum")
    plain = sg_mod.sparse_gram_ref(rows, vals, m)
    plain_err = max_err(plain, want)
    compare("sparse_gram", got, plain, rel, cases,
            f"{case}, against the plain version")
    del plain
    check_bit_stable("sparse_gram", case, got,
                     lambda: sg_mod.sparse_gram(rows, vals, m), calls)
    fields = dict(case=case, max_abs_err=err, plain_max_abs_err=plain_err,
                  limit=rel * float(want.abs().max()), bit_stable_calls=calls,
                  symmetric=bool(torch.equal(got, got.mT)),
                  max_asymmetry=max_err(got, got.mT))
    del got, want
    return fields


def sketch_panel_case(cases, case, omega, rows, vals, *,
                      calls: int = 10) -> dict:
    """sketch_panel held to its plain version at 1e-5 of max|plain|
    (``equal`` says whether the bits agree), ``calls`` further calls giving
    the same bits, and the device kernels of one call."""
    got = sp_mod.sketch_panel(omega, rows, vals)
    want = sp_mod.sketch_panel_ref(omega, rows, vals)
    err = compare("sketch_panel", got, want, 1e-5, cases, case)
    equal = bool(torch.equal(got, want))
    check_bit_stable("sketch_panel", case, got,
                     lambda: sp_mod.sketch_panel(omega, rows, vals), calls)
    l, m = omega.shape[-2:]
    strides = omega.stride()[-2:]
    fields = dict(case=case, max_abs_err=err, equal_to_plain=equal,
                  limit=1e-5 * float(want.abs().max()),
                  omega_strides=list(omega.stride()),
                  omega_route=sp_mod.omega_route(l, m, strides),
                  bit_stable_calls=calls,
                  device_kernels=device_kernels_per_call(
                      lambda: sp_mod.sketch_panel(omega, rows, vals)))
    check_device_kernels("sketch_panel", case, fields["device_kernels"],
                         sp_mod.device_kernels(l, m, strides))
    del got, want
    return fields


def ell_csr(rows, vals, m):
    """The block-stacked (D*C, M) CSR of the stored columns (the cuSPARSE
    yardstick's operand), built from the ELL slots."""
    import warnings

    d, c, k = rows.shape
    live = vals.reshape(d * c, k) != 0
    counts = live.sum(dim=1)
    crow = torch.zeros(d * c + 1, dtype=torch.int64, device=rows.device)
    crow[1:] = counts.cumsum(0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # "beta" notices
        return torch.sparse_csr_tensor(
            crow, rows.reshape(d * c, k)[live].long(),
            vals.reshape(d * c, k)[live], size=(d * c, m),
            check_invariants=False)


def ell_blockdiag_csr(rows, vals, m):
    """(E, E^T) as CSR tensors: E the block-diagonal (D*M, D*C) matrix of
    the stored columns (block d's (M, C) panel at rows d*M, columns d*C),
    duplicate slots summed.  ``torch.sparse.mm(E, E^T)`` (cuSPARSE SpGEMM)
    is the one PyTorch call that computes sparse_gram's function: its
    (D*M, D*M) result holds G_d on the diagonal and nothing else."""
    import warnings

    d, c, _ = rows.shape
    live = vals != 0
    blk, col, _ = live.nonzero(as_tuple=True)
    r = rows[live].long() + blk * m
    col = col + blk * c
    v = vals[live]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # "beta" notices
        e = torch.sparse_coo_tensor(torch.stack([r, col]), v,
                                    (d * m, d * c)).coalesce()
        et = torch.sparse_coo_tensor(torch.stack([col, r]), v,
                                     (d * c, d * m)).coalesce()
        return e.to_sparse_csr(), et.to_sparse_csr()


def sparse_gram_library(rows, vals, m, *, iters=10, want=None) -> dict:
    """The library yardstick of sparse_gram: ``torch.sparse.mm(E, E^T)``
    (:func:`ell_blockdiag_csr`, built outside the timed window; the port
    never calls it).  With ``want`` (the kernel's grams) its diagonal
    blocks are held to them at 1e-5 of max|G| and the rest to zero."""
    e, et = ell_blockdiag_csr(rows, vals, m)
    fields = dict(
        library_ms=time_ms(lambda: torch.sparse.mm(e, et), iters=iters),
        library="torch.sparse.mm(E, E^T), E the block-diagonal (D*M, D*C) "
                "CSR of the stored columns (cuSPARSE SpGEMM), built outside "
                "the timed window")
    if want is not None:
        g = torch.sparse.mm(e, et).to_dense()
        diag = torch.stack([g[i * m:(i + 1) * m, i * m:(i + 1) * m]
                            for i in range(rows.shape[0])])
        err = float((diag - want).abs().max())
        off = float(g.abs().sum() - diag.abs().sum())
        check(err <= 1e-5 * float(want.abs().max()) and off == 0.0,
              f"sparse_gram's library yardstick computes another function: "
              f"diagonal blocks err {err}, off-diagonal mass {off}")
        fields["library_max_abs_err"] = err
        del g, diag
    del e, et
    return fields


def sketch_timed(cases, case, omega, rows, vals, *, iters=10) -> dict:
    """sketch_panel_case, then the kernel's time beside its bound and the
    library yardstick: one ``torch.sparse.mm`` (cuSPARSE) of the
    block-stacked (D*C, M) CSR of the stored columns by Omega^T (the CSR
    built outside the timed window; the port never calls it)."""
    fields = sketch_panel_case(cases, case, omega, rows, vals)
    b_ms, b_by = sketch_panel_bound(omega, rows, vals)
    csr = ell_csr(rows, vals, omega.shape[1])
    om_t = omega.T
    fields.update(
        ms=time_ms(lambda: sp_mod.sketch_panel(omega, rows, vals),
                   iters=iters),
        device_ms=device_ms(lambda: sp_mod.sketch_panel(omega, rows, vals)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(lambda: torch.sparse.mm(csr, om_t), iters=iters),
        library="torch.sparse.mm((D*C, M) CSR, Omega^T), CSR built "
                "outside the timed window")
    del csr
    return fields


def rv_args(rep, u, s):
    """``rv_mod.right_vectors``' positional arguments for a repaired sparse
    stack: its ELL arrays, the repair side-band, the block width, U, S."""
    e = rep.ell
    return (e.col_ids, e.col_rows, e.col_vals, rep.repair_cols,
            rep.repair_mask, e.width, u, s)


def right_vectors_bound(args):
    """(bound_ms, bound_by): V written once, U read once, 8 bytes a term (a
    non-zero slot or a repair: row and value); a multiply and an add a term
    and column of V."""
    ids, _, vals, _, rmask, w, u, _ = args
    m, r = u.shape
    terms = float((vals != 0).sum() + rmask.sum())
    nbytes = ids.shape[0] * w * r * 4 + m * r * 4 + terms * 8
    return bound(nbytes, 2.0 * terms * r)


def max_err_rows(x, y, rows: int = 1 << 16) -> float:
    """``max_err`` a chunk of rows at a time: V at the exact cell's shape
    holds 2**31 floats, and its float64 copies would not fit beside it."""
    return max((max_err(x[i:i + rows], y[i:i + rows])
                for i in range(0, x.shape[0], rows)), default=0.0)


def right_vectors_case(cases, case, args, *, out_cols=None,
                       calls: int = 10) -> dict:
    """right_vectors held to its plain version at 1e-5 of max|plain|,
    ``calls`` further calls giving the same bits, and the device kernels of
    one call.  ``out_cols`` (width, start): V goes into columns start .. of a
    (D*W, width) panel of 7.0s, whose other columns must keep their
    value."""
    u = args[6]
    r = u.shape[1]

    def call(panels=None):
        if out_cols is None:
            return rv_mod.right_vectors(*args)
        width, start = out_cols
        panel = torch.full((args[0].shape[0] * args[5], width), 7.0,
                           device=DEVICE)
        if panels is not None:
            panels.append(panel)
        return rv_mod.right_vectors(*args, out=panel[:, start:start + r])

    panels = []
    got = call(panels)
    if panels:
        panel, start = panels.pop(), out_cols[1]
        check(bool((panel[:, :start] == 7.0).all())
              and bool((panel[:, start + r:] == 7.0).all()),
              f"right_vectors[{case}]: wrote outside its columns")
        del panel
    want = rv_mod.right_vectors_ref(*args)
    torch.cuda.synchronize()
    check(got.shape == want.shape and bool(torch.isfinite(got).all()),
          f"right_vectors[{case}]: shape {tuple(got.shape)} or non-finite")
    err = max_err_rows(got, want)
    limit = 1e-5 * float(want.abs().max())
    cases.append(dict(kernel="right_vectors", case=case, max_abs_err=err,
                      limit=limit))
    check(err <= limit, f"right_vectors[{case}]: max abs err {err} > limit "
          f"{limit}")
    equal = bool(torch.equal(got, want))
    del want
    check_bit_stable("right_vectors", case, got, call, calls)
    vec, tpr = rv_mod.row_plan(
        r, rv_mod.vec4_ok(r, rv_mod.rows_of(u), got))
    fields = dict(case=case, max_abs_err=err, limit=limit,
                  equal_to_plain=equal, bit_stable_calls=calls,
                  u_strides=list(u.stride()), out_strides=list(got.stride()),
                  vec=vec, threads_a_row=tpr,
                  device_kernels=device_kernels_per_call(call))
    # the panel's fill, and U's copy where its columns are strided
    check_device_kernels("right_vectors", case, fields["device_kernels"],
                         rv_mod.DEVICE_KERNELS + (out_cols is not None)
                         + (rv_mod.rows_of(u) is not u))
    del got
    return fields


def right_vectors_library(args, *, iters=10, want=None) -> dict:
    """The library yardstick of right_vectors: ``torch.sparse.mm`` of A^T,
    the (D*W, M) CSR of the stored non-zeros and the repairs (duplicates
    summed; built outside the timed window; the port never calls it), by U.
    With ``want`` (the kernel's V) its product times the masked 1/S is
    held to it at 1e-5 of max|V|."""
    from repro_torch.core.svd import masked_inverse

    ids, rows, vals, rcols, rmask, w, u, s = args
    d = ids.shape[0]
    live = vals != 0
    blk, col, _ = live.nonzero(as_tuple=True)
    rb, rj = rmask.nonzero(as_tuple=True)
    vrow = torch.cat([blk * w + ids[blk, col].long(),
                      rb * w + rcols[rb, rj].long()])
    urow = torch.cat([rows[live].long(), rj])
    v = torch.cat([vals[live], torch.ones(rb.numel(), device=vals.device)])
    at = torch.sparse_coo_tensor(torch.stack([vrow, urow]), v,
                                 (d * w, u.shape[0])).coalesce()
    at = at.to_sparse_csr()
    del blk, col, rb, rj, vrow, urow, v
    uc = u.contiguous()
    fields = dict(
        library_ms=time_ms(lambda: torch.sparse.mm(at, uc), iters=iters),
        library="torch.sparse.mm(A^T, U), A^T the (D*W, M) CSR of the "
                "stored non-zeros and repairs, built outside the timed window")
    if want is not None:
        lib = torch.sparse.mm(at, uc).mul_(masked_inverse(s)[None, :])
        err = max_err_rows(lib, want)
        check(err <= 1e-5 * float(want.abs().max()),
              f"right_vectors' library yardstick computes another function: "
              f"err {err}")
        fields["library_max_abs_err"] = err
        del lib
    del at, uc
    return fields


def right_vectors_timed(cases, case, args, *, out_cols=None, iters=10,
                        plain_iters=3) -> dict:
    """right_vectors_case, then the kernel's time (into the same kind of
    ``out``) beside its bound, its plain version and the library
    yardstick."""
    fields = right_vectors_case(cases, case, args, out_cols=out_cols)
    r = args[6].shape[1]
    out = None
    if out_cols is not None:
        width, start = out_cols
        out = torch.zeros((args[0].shape[0] * args[5], width),
                          device=DEVICE)[:, start:start + r]
    b_ms, b_by = right_vectors_bound(args)
    kernel = lambda: rv_mod.right_vectors(*args, out=out)   # noqa: E731
    fields.update(
        ms=time_ms(kernel, iters=iters), device_ms=device_ms(kernel),
        plain_ms=time_ms(lambda: rv_mod.right_vectors_ref(*args),
                         iters=plain_iters, warmup=1),
        bound_ms=b_ms, bound_by=b_by,
        **right_vectors_library(args, iters=iters, want=kernel()))
    del out
    return fields


# bf16 products per product of float32 values that blockgram's kernel
# makes: hi.hi + hi.mid + mid.hi + mid.mid + hi.lo + lo.hi, the least set
# that holds 1e-5 of max|G| on every input
# (tests/test_torch_kernel_numerics.py).
BLOCKGRAM_F32_PRODUCTS = 6
# Float32 values that blockgram's split into bf16 terms serves worst (the
# same as the CPU tests' WORST): products of them lose 3.0e-5 (two terms),
# 1.5e-5 (no mid.mid) and 1.5e-5 (no lo) of x^2 when those products are
# left out.
BLOCKGRAM_WORST = {"two terms": 1.0038985013961792,
                   "no mid.mid": 1.0039061307907104,
                   "no lo": 1.0020065307617188}


def gram_f64(a):
    """The yardstick of blockgram's checks: the gram summed in float64 and
    rounded once.  The plain version sums in float32, as the reference
    does, and on an H100 that errs 9.4e-6 to 1.55e-5 of max|G| at W =
    21363 (PERF.md), as much as the kernel is held to."""
    a64 = a.to(torch.float64)
    return (a64 @ a64.mT).to(torch.float32)


def products(a) -> int:
    """bf16 products per product of ``a``'s values that the kernel makes
    on this input: 1 when every value is exact in bf16 (bf16 input, 0/1
    data; the kernel skips mid and lo), 4 when every value is exact in two
    bf16 terms (it skips lo), else ``BLOCKGRAM_F32_PRODUCTS``."""
    if a.dtype != torch.float32:
        return 1
    rest = a - a.to(torch.bfloat16).float()
    if not bool(rest.any()):
        return 1
    if not bool((rest - rest.to(torch.bfloat16).float()).any()):
        return 4
    return BLOCKGRAM_F32_PRODUCTS


def blockgram_bound(a):
    """``bg_mod.work``: A read once, G written once, and a multiply and an
    add for each entry on or above the diagonal per column of A, at the
    fastest rate the card offers to a float32-accurate product: the bf16
    tensor-core rate over the t bf16 products this input needs
    (``products``), or the float32 rate if that is higher."""
    nbytes, flops = bg_mod.work(*a.shape, a.element_size())
    return bound(nbytes, flops, max(F32_FLOPS, BF16_FLOPS / products(a)))


def blockgram_worst(shape, x, seed):
    """Rows of +-x scaled by powers of two, so that every product of the
    split errs the same way (as the CPU tests' ``_bg_worst``)."""
    gen = torch.Generator(DEVICE).manual_seed(seed)
    sign = torch.randint(0, 2, shape, generator=gen, device=DEVICE) * 2 - 1
    scale = torch.exp2(torch.randint(-3, 4, shape, generator=gen,
                                     device=DEVICE).float())
    return (x * sign * scale).float()


def bmm_ms(a) -> float:
    """The yardstick only (the port never calls bmm for this product): one
    ``torch.bmm`` of the float32 blocks by their transposes."""
    a32 = a.float()
    return time_ms(lambda: torch.bmm(a32, a32.mT), iters=5, warmup=1)


def blockgram_variants(cases, shape, *, wcoo) -> list:
    """At the solver's shape: gaussian float32 (twice: the same bits), the
    weighted paper matrix made dense, bf16 input and rows of the values the
    split serves worst, each within 1e-5 of max|G| (``gram_f64``) and
    exactly symmetric; the gaussian and bf16 cases timed beside their bound
    and ``torch.bmm``."""
    d, m, w = shape
    out = []
    gauss = torch.randn(shape, generator=torch.Generator(DEVICE)
                        .manual_seed(31), device=DEVICE)
    for tag, a in (("gaussian f32", gauss),
                   ("gaussian rounded to bf16, bf16 input",
                    gauss.to(torch.bfloat16))):
        got = bg_mod.blockgram(a)
        want = gram_f64(a)
        err = compare("blockgram", got, want, 1e-5, cases,
                      f"{tag} {tuple(shape)}")
        plain_err = max_err(bg_mod.blockgram_ref(a), want)
        check(torch.equal(got, got.mT),
              f"blockgram[{tag}]: the gram is not exactly symmetric")
        if a.dtype == torch.float32:
            check(torch.equal(got, bg_mod.blockgram(a)),
                  f"blockgram[{tag}]: two calls differ")
        b_ms, b_by = blockgram_bound(a)
        ms = time_ms(lambda: bg_mod.blockgram(a), iters=5, warmup=1)
        out.append(dict(case=f"{tag} {tuple(shape)}", max_abs_err=err,
                        plain_max_abs_err=plain_err,
                        limit=1e-5 * float(want.abs().max()), ms=ms,
                        bound_ms=b_ms, bound_by=b_by,
                        products=products(a),
                        achieved_tflops=bg_mod.work(
                            *shape, a.element_size())[1] / ms / 1e9,
                        library_ms=bmm_ms(a)))
        del got, want
    del gauss
    dense = torch.from_numpy(sparse.pad_to_block_multiple(
        wcoo.todense(), NUM_BLOCKS)).to(DEVICE)
    wb = dense.reshape(m, NUM_BLOCKS, -1).permute(1, 0, 2).contiguous()
    del dense
    got = bg_mod.blockgram(wb)
    compare("blockgram", got, gram_f64(wb), 1e-5, cases,
            f"paper weighted, dense {tuple(wb.shape)}")
    check(torch.equal(got, got.mT), "blockgram[weighted]: not symmetric")
    del wb, got
    worst = blockgram_worst(shape, BLOCKGRAM_WORST["two terms"], 33)
    compare("blockgram", bg_mod.blockgram(worst), gram_f64(worst), 1e-5,
            cases, f"values the split serves worst (two terms) "
            f"{tuple(shape)}")
    return out


def sketch_panel_bound(omega, rows, vals):
    l = omega.shape[-2]
    d, c, _ = rows.shape
    nnz = float((vals != 0).sum())
    nbytes = (omega.numel() * 4 + rows.numel() * 4 + vals.numel() * 4
              + d * l * c * 4)
    return bound(nbytes, 2.0 * l * nnz)


def max_err(x, y) -> float:
    return float((x.double() - y.double()).abs().max()) if x.numel() else 0.0


def reset_counts() -> None:
    for mod in KERNEL_MODULES.values():
        mod.launches = 0


def read_counts() -> dict:
    return {name: mod.launches for name, mod in KERNEL_MODULES.items()}


# ---------------------------------------------------------------------------
# Phase 3: every kernel against its plain version
# ---------------------------------------------------------------------------

def compare(name, got, want, rel_limit, results, case):
    """Hold ``got`` to ``want`` (same shape and dtype) at
    ``rel_limit * max|want|`` (0 = exact)."""
    torch.cuda.synchronize()
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{name}[{case}]: shape/dtype {tuple(got.shape)} {got.dtype}, "
          f"want {tuple(want.shape)} {want.dtype}")
    check(torch.isfinite(got).all(), f"{name}[{case}]: non-finite output")
    err = max_err(got, want)
    limit = rel_limit * float(want.abs().max()) if want.numel() else 0.0
    results.append(dict(kernel=name, case=case, max_abs_err=err, limit=limit))
    check(err <= limit, f"{name}[{case}]: max abs err {err} > limit {limit}")
    return err


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bfloat16 values at |x| (8 significant bits), 0 at 0."""
    _, e = torch.frexp(x.float().abs())
    ulp = torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)
    return torch.where(x == 0, 0.0, ulp)


def compare_bf16(name, got, want, f32_rel, results, case):
    """Hold a bfloat16 ``got`` to ``want`` element by element at one bf16
    ulp of |want| plus ``f32_rel * max|want|``: both sides sum in float32
    (in another order, which the second term covers) and round to bf16
    once, which moves a value by at most one ulp."""
    torch.cuda.synchronize()
    check(got.shape == want.shape and got.dtype == want.dtype
          == torch.bfloat16,
          f"{name}[{case}]: shape/dtype {tuple(got.shape)} {got.dtype}, "
          f"want {tuple(want.shape)} bfloat16")
    check(torch.isfinite(got).all(), f"{name}[{case}]: non-finite output")
    diff = (got.float() - want.float()).abs()
    atol = f32_rel * float(want.abs().max())
    tol = bf16_ulp(want) + atol
    err = float(diff.max())
    worst = float((diff / tol).max())
    results.append(dict(kernel=name, case=case, max_abs_err=err,
                        limit="1 bf16 ulp of |plain| + atol", atol=atol,
                        worst_err_over_limit=worst))
    check(worst <= 1.0, f"{name}[{case}]: an element errs {worst} times its "
          f"limit (1 bf16 ulp of |plain| + {atol}); max abs err {err}")
    return err


def synthetic_ell(rng, d, c, k, m, *, weighted, empty_block=None,
                  heavy_row=None):
    """Random (D, C, K) ELL arrays with padding slots, duplicate rows inside
    a column, optionally one block whose slots are all padding, and
    optionally ``heavy_row`` = (row, columns): that row in the first
    ``columns`` columns of every block."""
    rows = rng.integers(0, m, size=(d, c, k)).astype(np.int32)
    vals = (rng.uniform(0.5, 2.0, size=(d, c, k)) if weighted
            else np.ones((d, c, k))).astype(np.float32)
    vals *= rng.random((d, c, k)) < 0.6            # padding slots
    if heavy_row is not None:
        r, cols = heavy_row
        rows[:, :cols, 0] = r
        vals[:, :cols, 0] = rng.uniform(0.5, 2.0, (d, cols)) if weighted \
            else 1.0
    rows[:, ::3, -1] = rows[:, ::3, 0]             # duplicates in a column
    if empty_block is not None:
        vals[empty_block] = 0.0
    rows[vals == 0] = 0
    return (torch.from_numpy(rows).to(DEVICE), torch.from_numpy(vals).to(DEVICE))


def sparse_gram_rows(cases, main, ell, well, ragged, rng) -> None:
    """``sparse_gram`` at the paper's shape (``ell``, 0/1; ``well``, the
    same matrix weighted) and on synthetic cases (``ragged``: D=3 C=37 K=5
    M=67 with duplicates and an all-padding block 1)."""
    rows, vals, m = ell.col_rows, ell.col_vals, ell.m
    # The paper's 0/1 ELL: exact, the same bits over 10 calls; then the
    # weighted paper matrix, a ragged case with duplicates and an
    # all-padding block, a row longer than one sorted piece
    # (sg_mod.SEG_CAP) spread over all warps, K = 36 > 32, M = 33 (not a
    # multiple of 32) and M above the shared-memory row chunk
    # (sg_mod.ROW_CHUNK), each against a float64 sum at 1e-5 of max|G|.
    sg_cases = [sparse_gram_case(cases, "paper 0/1 (exact)", rows, vals, m)]
    b_ms, b_by = sparse_gram_bound(rows, vals, m)
    main["sparse_gram"] = dict(
        shape=f"rows/vals {tuple(rows.shape)} -> {(rows.shape[0], m, m)}",
        max_abs_err=sg_cases[0]["max_abs_err"],
        ms=time_ms(lambda: sg_mod.sparse_gram(rows, vals, m)),
        device_ms=device_ms(lambda: sg_mod.sparse_gram(rows, vals, m)),
        plain_ms=time_ms(lambda: sg_mod.sparse_gram_ref(rows, vals, m)),
        bound_ms=b_ms, bound_by=b_by,
        **sparse_gram_library(rows, vals, m,
                              want=sg_mod.sparse_gram(rows, vals, m)),
        device_kernels=device_kernels_per_call(
            lambda: sg_mod.sparse_gram(rows, vals, m)),
        timed_variants=[])
    check_device_kernels("sparse_gram", "paper 0/1",
                         main["sparse_gram"]["device_kernels"],
                         sg_mod.DEVICE_KERNELS)

    sg_cases.append(sparse_gram_case(cases, "paper shape, weighted",
                                     well.col_rows, well.col_vals, m))
    r2, v2 = ragged
    sg_cases.append(sparse_gram_case(
        cases, "ragged D=3 C=37 K=5 M=67, duplicates, block 1 all padding",
        r2, v2, 67))
    check(float(sg_mod.sparse_gram(r2, v2, 67)[1].abs().max()) == 0.0,
          "sparse_gram: an all-padding block must give a zero gram")
    heavy = sg_mod.SEG_CAP * 2 + 400
    rh, vh = synthetic_ell(rng, 2, heavy + 600, 3, 40, weighted=True,
                           heavy_row=(5, heavy))
    sg_cases.append(sparse_gram_case(
        cases, f"a row in {heavy} columns (pieces of {sg_mod.SEG_CAP}, "
        f"{sg_mod.WARPS} warps), D=2 K=3 M=40", rh, vh, 40))
    for tag, (d_, c_, k_, m_, kw) in {
            "K=36 > 32, M=100": (2, 300, 36, 100, {}),
            "M=33, K=1": (2, 64, 1, 33, {}),
            f"M=2500 > the row chunk {sg_mod.ROW_CHUNK}, a row in 2100 "
            f"columns": (1, 3000, 2, 2500, dict(heavy_row=(7, 2100))),
    }.items():
        rx, vx = synthetic_ell(rng, d_, c_, k_, m_, weighted=True, **kw)
        sg_cases.append(sparse_gram_case(cases, tag, rx, vx, m_))
    rx, vx = synthetic_ell(rng, 2, 300, 36, 100, weighted=False)
    sg_cases.append(sparse_gram_case(cases, "K=36 > 32, M=100, 0/1 (exact)",
                                     rx, vx, 100))
    main["sparse_gram"]["checked"] = sg_cases


def sketch_panel_rows(cases, main, ell, well, ragged, rng) -> None:
    """``sketch_panel`` on the paper's ELL (``ell``; ``well`` weighted) and
    on synthetic cases (``ragged`` as for ``sparse_gram_rows``)."""
    rows, vals, m = ell.col_rows, ell.col_vals, ell.m
    # Omega as draw_omega gives it ((L, M) contiguous) and as the transpose
    # of an (M, L)-contiguous tensor, at L = 24 (the paper's sketch), 41
    # and 64; weighted data; a ragged case with duplicates and an
    # all-padding block; K = 36 > 32 and K = 1300 (a column taken in
    # pieces) with Omega too large to stage, in both layouts and in
    # neither (the wrapper's copy).  Each within 1e-5 of max|plain| and the
    # same bits over 10 calls.
    omega = torch.from_numpy(rng.standard_normal((24, m))
                             .astype(np.float32)).to(DEVICE)
    main["sketch_panel"] = sketch_timed(cases, "paper ELL, omega (24, 539)",
                                        omega, rows, vals)
    main["sketch_panel"].update(
        shape=f"omega {tuple(omega.shape)}, rows/vals {tuple(rows.shape)} "
              f"-> {(rows.shape[0], 24, rows.shape[1])}",
        plain_ms=time_ms(lambda: sp_mod.sketch_panel_ref(omega, rows, vals)),
        timed_variants=[])
    sp_cases = [sketch_panel_case(
        cases, "paper ELL, omega (24, 539) as the transpose of (539, 24)",
        omega.T.contiguous().T, rows, vals)]
    sp_cases.append(sketch_panel_case(cases, "paper shape, weighted", omega,
                                      well.col_rows, well.col_vals))
    for l_ in (41, 64):
        om = torch.from_numpy(rng.standard_normal((l_, m))
                              .astype(np.float32)).to(DEVICE)
        sp_cases.append(sketch_panel_case(cases, f"paper ELL, L={l_}", om,
                                          rows, vals))
    r2, v2 = ragged
    om2 = torch.from_numpy(rng.standard_normal((41, 67))
                           .astype(np.float32)).to(DEVICE)
    sp_cases.append(sketch_panel_case(
        cases, "ragged L=41 M=67 C=37 K=5, duplicates, block 1 all padding",
        om2, r2, v2))
    check(float(sp_mod.sketch_panel(om2, r2, v2)[1].abs().max()) == 0.0,
          "sketch_panel: an all-padding block must give a zero panel")
    for k_, c_, l_ in ((36, 300, 64), (36, 300, 41), (1300, 40, 8)):
        m_ = 2000 if k_ == 36 else 5000
        rx, vx = synthetic_ell(rng, 2, c_, k_, m_, weighted=True)
        om = torch.randn((l_, m_), device=DEVICE)
        for layout, o in (("(L, M)", om), ("(M, L)", om.T.contiguous().T),
                          ("neither (every other column)",
                           torch.randn((l_, 2 * m_), device=DEVICE)[:, ::2])):
            sp_cases.append(sketch_panel_case(
                cases, f"K={k_} C={c_} M={m_} L={l_}, omega {layout}", o,
                rx, vx))
    # A (D, L, M) Omega stack, one Omega_d a block (the power passes of the
    # hierarchical tree's sketch leaves): as the batched QR's Q_d^T come
    # ((L, M) contiguous, transposed in the kernel), as (M, L)-contiguous
    # matrices and in neither layout; the paper's ELL and the ragged case.
    om3 = torch.from_numpy(rng.standard_normal((rows.shape[0], 24, m))
                           .astype(np.float32)).to(DEVICE)
    for layout, o in (("(L, M) each", om3), ("(M, L) each",
                                            om3.mT.contiguous().mT),
                      ("neither (every other column)",
                       torch.randn((rows.shape[0], 24, 2 * m),
                                   device=DEVICE)[:, :, ::2])):
        sp_cases.append(sketch_panel_case(
            cases, f"paper ELL, omega stack {tuple(om3.shape)} {layout}", o,
            rows, vals))
    om3r = torch.randn((r2.shape[0], 41, 67), device=DEVICE)
    sp_cases.append(sketch_panel_case(
        cases, "ragged L=41 M=67 C=37 K=5, omega stack (3, 41, 67)", om3r,
        r2, v2))
    main["sketch_panel"]["checked"] = sp_cases


def right_vectors_rows(cases, main, ell, rng) -> None:
    """``right_vectors`` on the repaired paper matrix (U square: a row
    stride of 539 floats takes the scalar path; timed), then a column slice
    of U into an unaligned column slice of a wider panel with S
    rank-deficient, and a ragged stack with two stored columns on one id
    and an all-padding block, at a square U (67 floats a row: scalar) and
    a narrow one (16: float4)."""
    rep = ranky.split_and_repair(ell, NUM_BLOCKS, "neighbor_random",
                                 api.SolveConfig().resolved_key())
    m = ell.m
    gen = torch.Generator(DEVICE).manual_seed(41)

    def s_of(r):
        return torch.sort(torch.rand(r, device=DEVICE, generator=gen) * 40
                          + 0.5, descending=True).values

    u = torch.randn((m, m), device=DEVICE, generator=gen)
    main["right_vectors"] = right_vectors_timed(
        cases, "paper ELL, repaired, U square", rv_args(rep, u, s_of(m)))
    main["right_vectors"].update(
        shape=f"ids {tuple(ell.col_ids.shape)}, rows/vals "
              f"{tuple(ell.col_rows.shape)}, U {tuple(u.shape)} -> "
              f"{(NUM_BLOCKS * ell.width, m)}",
        timed_variants=[])
    checked = []
    u_wide = torch.randn((m, 40), device=DEVICE, generator=gen)
    s24 = s_of(24)
    s24[-3:] = torch.tensor([1e-9, 1e-12, 0.0], device=DEVICE)
    checked.append(right_vectors_case(
        cases, "paper ELL, U[:, 1:25] of a (539, 40) U into columns 13-36 "
        "of a (D*W, 37) panel, S rank-deficient",
        rv_args(rep, u_wide[:, 1:25], s24), out_cols=(37, 13)))
    rows, vals = synthetic_ell(rng, 3, 37, 5, 67, weighted=True,
                               empty_block=1)
    w = 50
    ids = np.stack([rng.choice(w, 37, replace=False) for _ in range(3)])
    ids[0, 4] = ids[0, 2]
    ids = torch.from_numpy(ids.astype(np.int32)).to(DEVICE)
    rcols = torch.from_numpy(rng.integers(0, w, (3, 67)).astype(np.int32))
    rmask = torch.from_numpy(rng.random((3, 67)) < 0.3)
    for r in (67, 16):
        checked.append(right_vectors_case(
            cases, f"ragged D=3 C=37 K=5 M=67 W=50, two stored columns on "
            f"one id, block 1 all padding, U (67, {r})",
            (ids, rows, vals, rcols.to(DEVICE), rmask.to(DEVICE), w,
             torch.randn((67, r), device=DEVICE, generator=gen), s_of(r))))
    main["right_vectors"]["checked"] = checked


def phase_kernels(state) -> None:
    cfg = RankyPaperConfig()
    coo = state["coo"]
    ell = state["ell"]
    rows, vals, m = ell.col_rows, ell.col_vals, ell.m
    cases = []
    main = {}
    rng = np.random.default_rng(7)

    wcoo = sparse.random_bipartite(cfg.rows, cfg.cols, cfg.density,
                                   seed=cfg.seed, weighted=True)
    well = sparse.block_ell_from_coo(wcoo, NUM_BLOCKS, device=DEVICE)
    ragged = synthetic_ell(rng, 3, 37, 5, 67, weighted=True, empty_block=1)
    sparse_gram_rows(cases, main, ell, well, ragged, rng)

    # --- blockgram --------------------------------------------------------
    # The paper matrix made dense, the solver's dense input: 0/1 values, so
    # one bf16 product each and an exact gram.
    dense = torch.from_numpy(sparse.pad_to_block_multiple(
        coo.todense(), NUM_BLOCKS)).to(DEVICE)
    blocks = dense.reshape(m, NUM_BLOCKS, -1).permute(1, 0, 2).contiguous()
    del dense
    want = gram_f64(blocks)
    got = bg_mod.blockgram(blocks)
    err = compare("blockgram", got, want, 0.0, cases,
                  f"paper dense {tuple(blocks.shape)} 0/1 (exact)")
    check(torch.equal(got, got.mT), "blockgram: the gram is not exactly "
          "symmetric")
    b_ms, b_by = blockgram_bound(blocks)
    main["blockgram"] = dict(
        shape=f"{tuple(blocks.shape)} f32 -> {tuple(got.shape)}, "
              f"{bg_mod.launch_plan(*blocks.shape, blocks.dtype)[0]} slices "
              f"of W",
        max_abs_err=err,
        ms=time_ms(lambda: bg_mod.blockgram(blocks), iters=5, warmup=1),
        plain_ms=time_ms(lambda: bg_mod.blockgram_ref(blocks), iters=5,
                         warmup=1),
        bound_ms=b_ms, bound_by=b_by, products=products(blocks),
        library_ms=bmm_ms(blocks),
        device_kernels=device_kernels_per_call(
            lambda: bg_mod.blockgram(blocks)),
        timed_variants=blockgram_variants(cases, blocks.shape, wcoo=wcoo))
    del blocks, want, got
    small = []
    a_w = torch.from_numpy(rng.standard_normal((3, 67, 203))
                           .astype(np.float32)).to(DEVICE)
    small += [("ragged D=3 M=67 W=203, gaussian f32", a_w),
              ("ragged D=3 M=67 W=203, bf16 input", a_w.to(torch.bfloat16))]
    for shape in ((1, 8, 5), (2, 40, 64)):
        g = torch.from_numpy(rng.standard_normal(shape)
                             .astype(np.float32)).to(DEVICE)
        small.append((f"short rows {shape}, gaussian f32", g))
        mixed = g.clone()
        mixed[:, :, ::2] = mixed[:, :, ::2].to(torch.bfloat16).float()
        small.append((f"short rows {shape}, mixed (every other column "
                      f"exact in bf16)", mixed))
    for name, x in BLOCKGRAM_WORST.items():
        small.append((f"(2, 40, 203), values the split serves worst "
                      f"({name})", blockgram_worst((2, 40, 203), x, 34)))
    small.append(("M=130 W=31 (W below one stage)",
                  torch.from_numpy(rng.standard_normal((1, 130, 31))
                                   .astype(np.float32)).to(DEVICE)))
    for tag, a in small:
        compare("blockgram", bg_mod.blockgram(a), gram_f64(a), 1e-5, cases,
                tag)
    a_sl = torch.randn((1, 539, 170_893), device=DEVICE,
                       generator=torch.Generator(DEVICE).manual_seed(32))
    compare("blockgram", bg_mod.blockgram(a_sl), gram_f64(a_sl),
            1e-5, cases, f"one block (1, 539, 170893), "
            f"{bg_mod.launch_plan(1, 539, 170_893, torch.float32)[0]} slices")
    del a_sl

    sketch_panel_rows(cases, main, ell, well, ragged, rng)
    right_vectors_rows(cases, main, ell, rng)
    topk_kernel_rows(state, cases, main)
    flash_kernel_rows(cases, main)
    ssd_kernel_rows(cases, main)

    state["kernel_main"] = main
    state["kernel_cases"] = cases
    emit("kernels", cases=cases, main_shapes=main,
         tolerance="0 for 0/1 sparse_gram and blockgram and for "
                   "topk_score (torch.equal on values and indices); else "
                   "1e-5 * max|plain| (f32 summation order; blockgram and "
                   "sparse_gram are held against the gram summed in "
                   "float64); sparse_gram, sketch_panel and right_vectors "
                   "also the same bits over 10 calls (torch.equal); "
                   "flash_attention 2e-5 and "
                   "ssd_scan 1e-4 of max|plain| in float32 (online against "
                   "direct softmax; chunked scan against the sequential "
                   "recurrence); a bf16 output element by element at one "
                   "bf16 ulp of |plain| plus that float32 term (each side "
                   "rounds its float32 result to bf16 once); the ssd_scan "
                   "state (float32) at 1e-4")


# ---------------------------------------------------------------------------
# Phase 3, LM kernels: flash_attention and ssd_scan
# ---------------------------------------------------------------------------

def peak_for(dtype) -> float:
    return BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS


def flash_bound(q, k, *, causal=True, window=0):
    """(bound_ms, bound_by, operations, bytes) of ``fa_mod.work`` (the dry
    run's charge too): q, k, v and the output once; a multiply and an add
    per head dim for q.k and for p.v, per (query, key) pair that the mask
    shows, per query head."""
    b, hq, sq, d = q.shape
    nbytes, flops = fa_mod.work(b, hq, k.shape[1], sq, k.shape[2], d,
                                q.element_size(), causal=causal,
                                window=window)
    return (*bound(nbytes, flops, peak_for(q.dtype)), flops, nbytes)


def achieved(flops, nbytes, ms) -> dict:
    """The rates a kernel time stands for: operations and bytes of the
    function (the same counts as its bound) over the time."""
    return dict(achieved_tflops=flops / ms / 1e9,
                achieved_gb_s=nbytes / ms / 1e6)


def device_ms_by_kernel(fn, iters: int = 10) -> dict:
    """Device time per call of each kernel ``fn`` launches, by name
    (``cuda_events`` over ``iters`` warm calls); {} where the profiler saw
    no device time."""
    return {key[:80]: dev / 1e3 / iters
            for key, _, dev in cuda_events(fn, iters) if dev > 0}


def lm_randn(shape, gen, dtype):
    return torch.randn(shape, generator=gen, device=DEVICE).to(dtype)


# The kernel's log-sum-exp output against the plain version's, relative to
# max|lse| over the rows that see a key (those that see none: -inf in both).
LSE_REL = {torch.float32: 1e-5, torch.bfloat16: 1e-3}


def flash_case(cases, case, b, hq, hkv, sq, sk, d, dtype, gen, **kw):
    q = lm_randn((b, hq, sq, d), gen, dtype)
    k = lm_randn((b, hkv, sk, d), gen, dtype)
    v = lm_randn((b, hkv, sk, d), gen, dtype)
    got = fa_mod.flash_attention(q, k, v, **kw)
    want, want_lse = fa_mod.flash_attention_ref(q, k, v, return_lse=True,
                                                **kw)
    hold = compare_bf16 if dtype == torch.bfloat16 else compare
    err = hold("flash_attention", got, want, 2e-5, cases, case)
    del want
    flash_lse_case(cases, case, q, k, v, got, want_lse, kw)
    return q, k, v, got, err


def flash_lse_case(cases, case, q, k, v, got, want_lse, kw) -> None:
    """The kernel asked for its log-sum-exp too (what the training forward
    asks): the same output bits, and lse against the plain version's."""
    out, lse = fa_mod._forward(q, k, v, kw.get("causal", True),
                               kw.get("window", 0), kw.get("softcap", 0.0),
                               q.shape[-1] ** -0.5, True)
    torch.cuda.synchronize()
    check(torch.equal(out, got), f"flash_attention[{case}]: the output with "
          f"lse asked for differs from the one without")
    fin = torch.isfinite(want_lse)
    check(torch.equal(fin, torch.isfinite(lse))
          and bool((lse[~fin] == float("-inf")).all()),
          f"flash_attention[{case}]: lse is not -inf exactly on the rows "
          f"that see no key")
    err = max_err(lse[fin], want_lse[fin])
    top = float(want_lse[fin].abs().max()) if bool(fin.any()) else 0.0
    limit = LSE_REL[q.dtype] * top
    cases.append(dict(kernel="flash_attention", case=case + " lse",
                      max_abs_err=err, limit=limit,
                      rows_seeing_no_key=int((~fin).sum())))
    check(err <= limit, f"flash_attention[{case}]: lse max abs err {err} > "
          f"limit {limit}")


def sdpa_ms(q, k, v, causal) -> float:
    """The yardstick only (the port never calls SDPA): one SDPA call on the
    same inputs, K and V expanded to the query heads beforehand."""
    group = q.shape[1] // k.shape[1]
    kk = k.repeat_interleave(group, dim=1)
    vv = v.repeat_interleave(group, dim=1)
    return time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, kk, vv, is_causal=causal))


def flash_timed(cases, case, shape, dtype, gen, causal=True) -> dict:
    """flash_case, then the kernel's time beside its bound and SDPA's."""
    q, k, v, _, err = flash_case(cases, case, *shape, dtype, gen,
                                 causal=causal)
    b_ms, b_by, flops, nbytes = flash_bound(q, k, causal=causal)
    ms = time_ms(lambda: fa_mod.flash_attention(q, k, v, causal=causal))
    return dict(case=case, max_abs_err=err, ms=ms, bound_ms=b_ms,
                bound_by=b_by, **achieved(flops, nbytes, ms),
                library_ms=sdpa_ms(q, k, v, causal))


def flash_kernel_rows(cases, main) -> None:
    """The main shape of the LM prefill, (8, 32, 1024, 80) causal, in bf16
    (the config's type) and float32, timed; the long prompt (2, 32, 3000,
    80) and a head-dim-128 GQA shape timed beside SDPA too; variants
    checked: GQA, window, softcap, non-causal, right-aligned, ragged, rows
    that see no key."""
    gen = torch.Generator(DEVICE).manual_seed(21)
    pf = LM_PREFILL
    cfg = get_config(LM_ARCH)
    shape = (pf["batch"], cfg.padded_heads, cfg.padded_kv_heads, pf["seq"],
             pf["seq"], cfg.head_dim)
    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        tag = str(dtype).replace("torch.", "")
        q, k, v, _, err = flash_case(cases, f"main {shape} {tag} causal",
                                     *shape, dtype, gen)
        b_ms, b_by, flops, nbytes = flash_bound(q, k)
        ms = time_ms(lambda: fa_mod.flash_attention(q, k, v))
        rows[tag] = dict(
            shape=f"q, k, v {tuple(q.shape)} {tag}, causal", max_abs_err=err,
            ms=ms,
            plain_ms=time_ms(lambda: fa_mod.flash_attention_ref(q, k, v),
                             iters=3, warmup=1),
            bound_ms=b_ms, bound_by=b_by, **achieved(flops, nbytes, ms),
            library_ms=sdpa_ms(q, k, v, True),
            device_kernels=device_kernels_per_call(
                lambda: fa_mod.flash_attention(q, k, v)))
        del q, k, v
    variants = [
        ("GQA Hq 8 Hkv 2", (2, 8, 2, 1024, 1024, 80), {}),
        ("window 256", (2, 8, 8, 1024, 1024, 80), dict(window=256)),
        ("softcap 50", (2, 8, 8, 1024, 1024, 80), dict(softcap=50.0)),
        ("non-causal", (2, 8, 8, 1024, 1024, 80), dict(causal=False)),
        ("right-aligned sq 256 < sk 1024", (2, 8, 2, 256, 1024, 80), {}),
        ("ragged sq = sk = 1000", (2, 8, 2, 1000, 1000, 80), {}),
        ("ragged sq 1 sk 777", (3, 8, 2, 1, 777, 80), {}),
        ("head dim 128, window + softcap, non-causal",
         (1, 4, 2, 300, 300, 128),
         dict(causal=False, window=64, softcap=30.0)),
    ]
    timed = []
    for dtype in (torch.bfloat16, torch.float32):
        tag = str(dtype).replace("torch.", "")
        for name, shp, kw in variants:
            flash_case(cases, f"{name} {tag}", *shp, dtype, gen, **kw)
        timed.append(flash_timed(
            cases, f"long prompt sq = sk = 3000 (lm_serve's long prefill) "
            f"{tag}", (LM_LONG["batch"], 32, 32, LM_LONG["seq"],
                       LM_LONG["seq"], 80), dtype, gen))
        timed.append(flash_timed(cases, f"head dim 128, GQA 32/8, causal "
                                 f"{tag}", (2, 32, 8, 1024, 1024, 128),
                                 dtype, gen))
    q, k, v, got, _ = flash_case(cases, "sq 100 > sk 60 (rows before every "
                                 "key)", 1, 4, 4, 100, 60, 80,
                                 torch.float32, gen)
    check(float(got[:, :, :40].abs().max()) == 0.0,
          "flash_attention: rows that see no key must be zeros")
    timed += flash_wide_rows(cases, gen)
    timed += flash_path_rows(cases, gen)
    timed += flash_whisper_rows(cases, gen)
    lse = [c for c in cases if c["kernel"] == "flash_attention"
           and c["case"].endswith(" lse")]
    main["flash_attention"] = dict(
        rows["bfloat16"], float32=rows["float32"], timed_variants=timed,
        lse=dict(cases=len(lse),
                 max_abs_err={tag: max(c["max_abs_err"] for c in lse
                                       if f" {tag}" in c["case"])
                              for tag in ("bfloat16", "float32")},
                 worst_err_over_limit=max(c["max_abs_err"] / c["limit"]
                                          for c in lse if c["limit"] > 0),
                 limit="1e-5 (float32) / 1e-3 (bf16) x max|lse| of the "
                       "plain version"))


def flash_wide_rows(cases, gen) -> list:
    """gemma2-9b's widths, q (8, 16, 1024, 256) over k, v (8, 8, 1024,
    256), causal, in bf16 and float32, timed beside SDPA; variants at head
    dim 256: window 256, softcap 50, ragged sq = sk = 1000, sq 256 < sk
    1024, and rows that see no key."""
    cfg = get_config(WIDE_ATTN_ARCH)
    shape = (LM_PREFILL["batch"], cfg.padded_heads, cfg.padded_kv_heads,
             LM_PREFILL["seq"], LM_PREFILL["seq"], cfg.head_dim)
    d = cfg.head_dim
    timed = []
    for dtype in (torch.bfloat16, torch.float32):
        tag = str(dtype).replace("torch.", "")
        timed.append(flash_timed(cases, f"{WIDE_ATTN_ARCH} {shape} causal "
                                 f"{tag}", shape, dtype, gen))
        for name, shp, kw in (
                ("window 256", (2, 16, 8, 1024, 1024, d), dict(window=256)),
                (f"softcap {cfg.logit_softcap:g}", (2, 16, 8, 1024, 1024, d),
                 dict(softcap=cfg.logit_softcap)),
                ("ragged sq = sk = 1000", (2, 16, 8, 1000, 1000, d), {}),
                ("right-aligned sq 256 < sk 1024", (2, 16, 8, 256, 1024, d),
                 {})):
            flash_case(cases, f"head dim {d}, {name} {tag}", *shp, dtype, gen,
                       **kw)
        _, _, _, got, _ = flash_case(
            cases, f"head dim {d}, sq 100 > sk 60 (rows before every key) "
            f"{tag}", 1, 4, 2, 100, 60, d, dtype, gen)
        check(float(got[:, :, :40].float().abs().max()) == 0.0,
              f"flash_attention: rows that see no key must be zeros (head "
              f"dim {d}, {tag})")
    return timed


def sdpa_band_ms(q, k, v, window: int) -> float:
    """The yardstick of a windowed causal call: one SDPA call with a
    boolean band mask (key j seen by query i iff i - window < j <= i; SDPA
    has no softcap), K and V expanded to the query heads beforehand."""
    group = q.shape[1] // k.shape[1]
    kk = k.repeat_interleave(group, dim=1)
    vv = v.repeat_interleave(group, dim=1)
    sq, sk = q.shape[2], k.shape[2]
    qi = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
    ki = torch.arange(sk, device=q.device)[None, :]
    band = (qi >= ki) & ((qi - ki) < window)
    return time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, kk, vv, attn_mask=band))


def flash_path_rows(cases, gen) -> list:
    """``flash_attention`` at phase 12b's shapes.  gemma2-9b's local-layer
    prefill, q (B, 16, 8192, 256) over k, v (B, 8, 8192, 256), causal,
    window 4,096, softcap 50, in bf16 and float32: held against the plain
    version at B = 1 (whose float32 scores are 4.3 GB), timed at B = 1 and
    at the phase's B = 2 beside its bound and SDPA with a boolean band
    mask.  starcoder2-15b's GQA group 12 at head dim 128, q (2, 48, 1024,
    128) over k, v (2, 4, 1024, 128), causal, bf16, timed beside its
    bound, the plain version and SDPA."""
    cfg = get_config(WIDE_ATTN_ARCH)
    w, cap, seq = cfg.attn_window, cfg.logit_softcap, GEMMA["seq"]
    hq, hkv, d = cfg.padded_heads, cfg.padded_kv_heads, cfg.head_dim
    kw = dict(window=w, softcap=cap)
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        tag = str(dtype).replace("torch.", "")
        case = (f"{WIDE_ATTN_ARCH} prefill {hq}/{hkv} heads of {d}, "
                f"{seq} tokens, causal, window {w}, softcap {cap:g} {tag}")
        q, k, v, _, err = flash_case(cases, f"{case}, B 1", 1, hq, hkv, seq,
                                     seq, d, dtype, gen, **kw)
        ms_b1 = time_ms(lambda: fa_mod.flash_attention(q, k, v, **kw))
        plain_b1 = time_ms(lambda: fa_mod.flash_attention_ref(q, k, v, **kw),
                           iters=3, warmup=1)
        del q, k, v
        torch.cuda.empty_cache()
        b = GEMMA["batch"]
        q = lm_randn((b, hq, seq, d), gen, dtype)
        k = lm_randn((b, hkv, seq, d), gen, dtype)
        v = lm_randn((b, hkv, seq, d), gen, dtype)
        b_ms, b_by, flops, nbytes = flash_bound(q, k, window=w)
        ms = time_ms(lambda: fa_mod.flash_attention(q, k, v, **kw))
        rows.append(dict(
            case=f"{case}, B {b}", max_abs_err=err, ms=ms, bound_ms=b_ms,
            bound_by=b_by, **achieved(flops, nbytes, ms),
            library_ms=sdpa_band_ms(q, k, v, w),
            library="SDPA with a boolean band mask (no softcap)",
            ms_b1=ms_b1, plain_ms_b1=plain_b1,
            max_abs_err_is="B 1 against the plain version"))
        del q, k, v
        torch.cuda.empty_cache()
    sc = get_config("starcoder2-15b")
    shape = (2, sc.padded_heads, sc.padded_kv_heads, 1024, 1024, sc.head_dim)
    row = flash_timed(cases, f"starcoder2-15b GQA {shape[1]}/{shape[2]} "
                      f"(group {shape[1] // shape[2]}), head dim "
                      f"{shape[5]}, 2 x 1024, causal bfloat16", shape,
                      torch.bfloat16, gen)
    q = lm_randn(shape[:2] + shape[3:4] + shape[5:], gen, torch.bfloat16)
    k = lm_randn((2, shape[2], 1024, shape[5]), gen, torch.bfloat16)
    row["plain_ms"] = time_ms(lambda: fa_mod.flash_attention_ref(q, k, k),
                              iters=3, warmup=1)
    rows.append(row)
    return rows


def flash_whisper_rows(cases, gen) -> list:
    """``flash_attention`` at phase 12c's whisper-small shapes, non-causal,
    heads padded as the model pads them (12 -> 16, head dim 64), in bf16
    and float32: the encoder over its 1,500 frames (a ragged key count,
    1,500 = 23 x 64 + 28), the decoder's 448 queries over the 1,500 encoder
    keys, and 2,048 queries over them (sq > sk, no causal offset); each
    held against the plain version and timed beside its bound, the plain
    version and SDPA."""
    cfg = get_config(WHISPER["arch"])
    h, d, se = cfg.padded_heads, cfg.head_dim, cfg.encoder_seq
    rows = []
    for name, b, sq in (("encoder", WHISPER["batch"], se),
                        ("cross", WHISPER["batch"], WHISPER["seq"]),
                        ("sq > sk", 1, 2048)):
        for dtype in (torch.bfloat16, torch.float32):
            tag = str(dtype).replace("torch.", "")
            shape = (b, h, h, sq, se, d)
            row = flash_timed(cases, f"whisper-small {name} q (B {b}, {h}, "
                              f"{sq}, {d}) over {se} keys, non-causal {tag}",
                              shape, dtype, gen, causal=False)
            q = lm_randn((b, h, sq, d), gen, dtype)
            k = lm_randn((b, h, se, d), gen, dtype)
            row["plain_ms"] = time_ms(lambda: fa_mod.flash_attention_ref(
                q, k, k, causal=False), iters=3, warmup=1)
            rows.append(row)
            del q, k
    return rows


def ssd_inputs(b, seq, h, g, p, n, dtype, gen):
    x = lm_randn((b, seq, h, p), gen, dtype)
    dt = (torch.nn.functional.softplus(
        torch.randn((b, seq, h), generator=gen, device=DEVICE)) * 0.1
          ).to(dtype)
    a = -torch.exp(torch.randn((h,), generator=gen, device=DEVICE))
    bm = (torch.randn((b, seq, g, n), generator=gen, device=DEVICE)
          / n ** 0.5).to(dtype)
    cm = (torch.randn((b, seq, g, n), generator=gen, device=DEVICE)
          / n ** 0.5).to(dtype)
    return x, dt, a, bm, cm


def ssd_bound(x, bm):
    """(bound_ms, bound_by, operations, bytes) of ``ss_mod.work``: the
    bytes read and written once and the recurrence's operations, whatever
    the kernel's chunk."""
    b, seq, h, p = x.shape
    nbytes, flops = ss_mod.work(b, seq, h, bm.shape[2], p, bm.shape[3],
                                x.element_size())
    return (*bound(nbytes, flops, peak_for(x.dtype)), flops, nbytes)


def ssd_case(cases, case, shape, dtype, gen, inputs=None):
    args = inputs or ssd_inputs(*shape, dtype, gen)
    y, hf = ss_mod.ssd_scan(*args)
    yr, hr = ss_mod.ssd_scan_ref(*args)
    hold = compare_bf16 if dtype == torch.bfloat16 else compare
    err = hold("ssd_scan", y, yr, 1e-4, cases, case + " y")
    err_h = compare("ssd_scan", hf, hr, 1e-4, cases, case + " state")
    return args, max(err, err_h), hf


def ssd_timed(cases, case, shape, dtype, gen) -> dict:
    """ssd_case, then the kernel's time beside its bound and the rates."""
    args, err, _ = ssd_case(cases, case, shape, dtype, gen)
    b_ms, b_by, flops, nbytes = ssd_bound(args[0], args[3])
    ms = time_ms(lambda: ss_mod.ssd_scan(*args))
    return dict(case=case, max_abs_err=err, ms=ms, bound_ms=b_ms,
                bound_by=b_by, **achieved(flops, nbytes, ms))


def ssd_kernel_rows(cases, main) -> None:
    """The main shape of the LM prefill, x (8, 1024, 80, 64), G 1, N 64, in
    bf16 and float32, timed; the long prompt (2, 3000, 80, 64) timed
    beside it; variants: G = 2, G = H = 8, ragged L = 1000, L = 1 and
    L = 11 (a chunk shorter than one 16-row MMA tile), P = N = 16, and a
    decaying state that forgets its first half."""
    gen = torch.Generator(DEVICE).manual_seed(22)
    cfg = get_config(LM_ARCH)
    pf = LM_PREFILL
    shape = (pf["batch"], pf["seq"], cfg.ssm_heads, cfg.ssm_groups,
             cfg.ssm_head_dim, cfg.ssm_state)
    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        tag = str(dtype).replace("torch.", "")
        args, err, _ = ssd_case(cases, f"main {shape} {tag}", shape, dtype,
                                gen)
        b_ms, b_by, flops, nbytes = ssd_bound(args[0], args[3])
        ms = time_ms(lambda: ss_mod.ssd_scan(*args))
        rows[tag] = dict(
            shape=f"x {tuple(args[0].shape)} {tag}, G {shape[3]}, N "
                  f"{shape[5]}, chunk {ss_mod.chunk_for(dtype, shape[5])}",
            max_abs_err=err,
            ms=ms,
            plain_ms=time_ms(lambda: ss_mod.ssd_scan_ref(*args), iters=2,
                             warmup=1),
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
            device_kernels=device_kernels_per_call(
                lambda: ss_mod.ssd_scan(*args)),
            **achieved(flops, nbytes, ms))
        del args
    timed = []
    for dtype in (torch.bfloat16, torch.float32):
        tag = str(dtype).replace("torch.", "")
        timed.append(ssd_timed(
            cases, f"long prompt L 3000 (lm_serve's long prefill) {tag}",
            (LM_LONG["batch"], LM_LONG["seq"], cfg.ssm_heads,
             cfg.ssm_groups, cfg.ssm_head_dim, cfg.ssm_state), dtype, gen))
        ssd_case(cases, f"G 2 {tag}", (4, 1024, 80, 2, 64, 64), dtype, gen)
        ssd_case(cases, f"G = H = 8 {tag}", (4, 1024, 8, 8, 64, 64), dtype,
                 gen)
        ssd_case(cases, f"ragged L 1000 {tag}", (2, 1000, 80, 1, 64, 64),
                 dtype, gen)
        ssd_case(cases, f"L 1 {tag}", (4, 1, 80, 1, 64, 64), dtype, gen)
        ssd_case(cases, f"L 11 {tag}", (4, 11, 80, 2, 64, 64), dtype, gen)
        ssd_case(cases, f"smoke widths P 16 N 16, L 300 {tag}",
                 (2, 300, 8, 1, 16, 16), dtype, gen)
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).replace("torch.", "")
        for n in (64, 128):
            x, _, _, bm, cm = ssd_inputs(1, 256, 8, 1, 64, n, dtype, gen)
            dt = torch.full((1, 256, 8), 2.0, device=DEVICE, dtype=dtype)
            a = torch.full((8,), -10.0, device=DEVICE)
            _, _, h1 = ssd_case(cases, f"decaying state N {n} {tag}", None,
                                dtype, gen, inputs=(x, dt, a, bm, cm))
            x2 = x.clone()
            x2[:, :128] = lm_randn((1, 128, 8, 64), gen, dtype)
            h2 = ss_mod.ssd_scan(x2, dt, a, bm, cm)[1]
            check(torch.allclose(h1, h2, rtol=1e-4, atol=1e-4),
                  f"ssd_scan: a state with a = -10, dt = 2 must forget its "
                  f"first half (N {n}, {tag})")
    timed += ssd_wide_rows(cases, gen)
    main["ssd_scan"] = dict(rows["bfloat16"], float32=rows["float32"],
                            timed_variants=timed)


def ssd_wide_rows(cases, gen) -> list:
    """mamba2-1.3b's widths, x (8, 1024, 64, 64), G 1, N 128, in bf16 and
    float32, timed beside the bound; variants at N 128: ragged L 1000, L 1,
    L 11, G 2, and P 128 at a small batch."""
    cfg = get_config(SSM_ARCH)
    pf = LM_PREFILL
    shape = (pf["batch"], pf["seq"], cfg.ssm_heads, cfg.ssm_groups,
             cfg.ssm_head_dim, cfg.ssm_state)
    timed = []
    for dtype in (torch.bfloat16, torch.float32):
        tag = str(dtype).replace("torch.", "")
        row = ssd_timed(cases, f"{SSM_ARCH} {shape} {tag}, chunk "
                        f"{ss_mod.chunk_for(dtype, shape[5])}", shape, dtype,
                        gen)
        timed.append(row)
        h, p, n = shape[2], shape[4], shape[5]
        ssd_case(cases, f"N {n} ragged L 1000 {tag}", (2, 1000, h, 1, p, n),
                 dtype, gen)
        ssd_case(cases, f"N {n} L 1 {tag}", (4, 1, h, 1, p, n), dtype, gen)
        ssd_case(cases, f"N {n} L 11 {tag}", (4, 11, h, 2, p, n), dtype, gen)
        ssd_case(cases, f"N {n} G 2 {tag}", (4, 1024, h, 2, p, n), dtype, gen)
        ssd_case(cases, f"P 128 N 128 {tag}", (2, 512, 8, 1, 128, 128),
                 dtype, gen)
    return timed


# ---------------------------------------------------------------------------
# Float64 references of a repaired matrix
# ---------------------------------------------------------------------------

def dense_block64(blocks, d: int) -> torch.Tensor:
    """Block ``d`` of a repaired stack (either representation) as a dense
    float32 (M, W) tensor."""
    if isinstance(blocks, sparse.RepairedSparseBlocks):
        ell = blocks.ell
        one = sparse.RepairedSparseBlocks(
            sparse.BlockEll(ell.col_ids[d:d + 1], ell.col_rows[d:d + 1],
                            ell.col_vals[d:d + 1], m=ell.m, width=ell.width,
                            n=ell.width),
            blocks.repair_cols[d:d + 1], blocks.repair_mask[d:d + 1])
        return one.todense_blocks()[0]
    return blocks[d]


def reference_svals(blocks, num_blocks: int, chunk: int = 16384):
    """sqrt(eigvalsh(A64 A64^T)) of the repaired matrix, descending, the
    float64 gram accumulated block by block over column chunks so that the
    dense matrix is never held whole.  In float64 the gram's squared
    condition number costs about 1e-16 * S[0]^2 / S[i] in S[i]: far below
    every limit used here."""
    g = None
    for d in range(num_blocks):
        blk = dense_block64(blocks, d)
        if g is None:
            g = torch.zeros((blk.shape[0], blk.shape[0]),
                            dtype=torch.float64, device=blk.device)
        for c0 in range(0, blk.shape[1], chunk):
            a64 = blk[:, c0:c0 + chunk].double()
            g += a64 @ a64.T
        del blk
    ev = torch.linalg.eigvalsh(g)
    return torch.sqrt(torch.clamp(torch.flip(ev, dims=(0,)), min=0.0))


def check_exact_result(name, res, repaired, num_blocks, *, recon=True):
    """The checks phases 4, 5 and 7a share; returns the fields to print."""
    s_ref = reference_svals(repaired, num_blocks)
    s = res.s.double()
    check(res.s.shape == s_ref.shape and torch.isfinite(res.s).all()
          and torch.isfinite(res.u).all(), f"{name}: S/U shape or finiteness")
    ds = (s - s_ref).abs()
    limit = 2e-3 * float(s_ref[0])
    check(float(ds.max()) <= limit,
          f"{name}: max|dS| {float(ds.max())} > 2e-3*S[0] = {limit}")
    m = res.u.shape[0]
    ortho = float((res.u.T @ res.u
                   - torch.eye(m, device=res.u.device)).abs().max())
    check(ortho <= 1e-4, f"{name}: |U^T U - I|_max {ortho} > 1e-4")
    out = dict(s0=float(s[0]), s_last=float(s[-1]), max_abs_dS=float(ds.max()),
               dS_limit=limit, e_sigma=float(ds.sum()), ortho_err=ortho)
    if recon and res.v is not None:
        n = res.v.shape[0]
        num = 0.0
        den = 0.0
        us = res.u * res.s[None, :]
        for d in range(num_blocks):
            blk = dense_block64(repaired, d)
            w = blk.shape[1]
            lo, hi = d * w, min((d + 1) * w, n)
            if hi <= lo:
                continue
            approx = us @ res.v[lo:hi].T
            num += float(((approx - blk[:, :hi - lo]).double() ** 2).sum())
            den += float((blk[:, :hi - lo].double() ** 2).sum())
        rel = (num / den) ** 0.5
        check(rel <= 1e-3, f"{name}: |U S V^T - A|_F / |A|_F {rel} > 1e-3")
        out["recon_rel_fro"] = rel
    return out


def timed_svd(a, cfg, **kw):
    reset_counts()
    res = api.svd(a, cfg, **kw)
    counts = read_counts()
    return res, counts


def keep_counts(state, solve: str, counts) -> None:
    """File one solve's launch counts under its own name."""
    state.setdefault("launches_by_solve", {})[solve] = counts


def diag_fields(res, counts):
    dg = res.diagnostics
    return dict(backend=res.plan.backend, strategy=res.plan.strategy,
                wall_time_s=dg.wall_time_s, compile_time_s=dg.compile_time_s,
                lonely_rows=dg.lonely_rows, repaired_rows=dg.repaired_rows,
                launches=counts)


class SpanRecord:
    """The obs spans of one :func:`spans` block: ``times`` {name: [ms,
    ...]} in order of first run, ``summary`` ``obs.span_summary`` of them."""

    def __init__(self):
        self.times = {}
        self.summary = ()


@contextlib.contextmanager
def spans():
    """Where the time of the block's calls goes, from the solver's obs
    spans: obs is on for the block only (its ring, registry and drift
    memo cleared at both ends).  A span's duration is the device time
    between its two CUDA events; spans nest (``svd.solve`` and
    ``ingest.batch`` hold the stages inside them), so the names do not add
    up to a wall time.  Obs on also arms the drift probe, which resets the
    peak-memory counter: never measure peaks inside this block."""
    rec = SpanRecord()
    obs.enable()
    obs.reset()
    try:
        yield rec
    finally:
        torch.cuda.synchronize()
        evs = obs.trace.events()
        for ev in evs:
            if ev.ph == "X":
                rec.times.setdefault(ev.name, []).append(ev.dur_us / 1e3)
        rec.summary = obs.span_summary(evs)
        obs.disable()
        obs.reset()


def stage_ms(a, cfg, reps: int = 3) -> dict:
    """Where a warm solve's time goes, from the solver's obs spans:
    ``api.svd(a, cfg)`` is run ``reps`` more times inside :func:`spans` and
    the run with the least wall time is kept.  A span that ran n times is
    summed and named ``span xn``; ``recorded_wall_ms`` is the same run's
    ``wall_time_s``; ``diagnostics`` runs after the solve's wall time ends.
    Made after the solve it describes: the launches here are not the main
    path's."""
    best = None
    for _ in range(reps):
        with spans() as rec:
            res = api.svd(a, cfg)
        wall = res.diagnostics.wall_time_s
        if best is None or wall < best[0]:
            best = (wall, rec)
    wall, rec = best
    out = sum_stages(rec)
    out["recorded_wall_ms"] = wall * 1e3
    return out


# ---------------------------------------------------------------------------
# Phases 4-7: the solves
# ---------------------------------------------------------------------------

def phase_solve_sparse_exact(state) -> None:
    coo = state["coo"]
    for merge_mode in ("gram", "proxy"):
        cfg = api.SolveConfig(method="neighbor_random", num_blocks=NUM_BLOCKS,
                              merge_mode=merge_mode, use_kernel=True,
                              want_right=True)
        res, counts = timed_svd(coo, cfg)
        name = f"solve_sparse_exact[{merge_mode}]"
        keep_counts(state, name, counts)
        check(res.plan.backend == "single", f"{name}: backend")
        check(res.plan.strategy == f"exact_{merge_mode}", f"{name}: strategy")
        check(counts["sparse_gram"] >= 1,
              f"{name}: sparse_gram was not launched")
        check(counts["right_vectors"] == 1, f"{name}: right_vectors "
              f"launched {counts['right_vectors']} times, want once over "
              f"the D-stack")
        check(res.diagnostics.lonely_rows == res.diagnostics.repaired_rows,
              f"{name}: lonely_rows != repaired_rows")
        check(res.v is not None and res.v.shape == (coo.shape[1],
                                                    coo.shape[0]),
              f"{name}: V shape")
        repaired = ranky.split_and_repair(state["ell"], NUM_BLOCKS,
                                          cfg.method, cfg.resolved_key())
        fields = check_exact_result(name, res, repaired, NUM_BLOCKS)
        res2, _ = timed_svd(coo, cfg)
        emit("solve_sparse_exact", merge_mode=merge_mode,
             warm_wall_time_s=res2.diagnostics.wall_time_s,
             stage_ms=stage_ms(coo, cfg),
             **diag_fields(res, counts), **fields)
    state["sparse_random_repair"] = ranky.split_and_repair(
        state["ell"], NUM_BLOCKS, "random", api.SolveConfig().resolved_key())


def phase_solve_dense_exact(state) -> None:
    coo = state["coo"]
    dense = coo.todense()                          # (539, 170897) f32, host
    cfg = api.SolveConfig(method="neighbor_random", num_blocks=NUM_BLOCKS,
                          merge_mode="gram", use_kernel=True, want_right=True)
    res, counts = timed_svd(dense, cfg)
    name = "solve_dense_exact"
    keep_counts(state, name, counts)
    check(res.plan.backend == "single" and res.plan.strategy == "exact_gram",
          f"{name}: plan")
    check(counts["blockgram"] >= 1, f"{name}: blockgram was not launched")
    check(res.diagnostics.lonely_rows == res.diagnostics.repaired_rows,
          f"{name}: lonely_rows != repaired_rows")
    a_norm = api.as_block_input(dense, NUM_BLOCKS, device=DEVICE)
    repaired = ranky.split_and_repair(a_norm, NUM_BLOCKS, cfg.method,
                                      cfg.resolved_key())
    fields = check_exact_result(name, res, repaired, NUM_BLOCKS)
    del repaired
    res2, _ = timed_svd(dense, cfg)

    # method="random", same key: the dense repair lands on the very columns
    # the sparse side-band names.
    rep_dense = ranky.split_and_repair(a_norm, NUM_BLOCKS, "random",
                                       cfg.resolved_key())
    rep_sparse = state["sparse_random_repair"]
    lonely = rep_sparse.repair_mask
    d_idx, r_idx = torch.nonzero(lonely, as_tuple=True)
    hit = rep_dense[d_idx, r_idx, rep_sparse.repair_cols[lonely].long()]
    check(bool((hit == 1).all()), f"{name}: dense and sparse random repairs "
          "differ on lonely rows")
    rows_sum = rep_dense[d_idx, r_idx].sum(dim=1)
    check(bool((rows_sum == 1).all()),
          f"{name}: a repaired lonely row holds more than its one entry")
    del a_norm, rep_dense
    emit("solve_dense_exact", warm_wall_time_s=res2.diagnostics.wall_time_s,
         stage_ms=stage_ms(dense, cfg),
         random_repair_parity_rows=int(lonely.sum()),
         **diag_fields(res, counts), **fields)


def check_topk(name, s, s_ref, k):
    s = s.double().cpu()
    s_ref = torch.as_tensor(np.asarray(s_ref, dtype=np.float64))[:k]
    check(s.shape == (k,) and torch.isfinite(s).all(), f"{name}: S shape")
    tol = 1e-3 * s_ref.abs() + 1e-3 * float(s_ref[0])
    err = (s - s_ref).abs()
    check(bool((err <= tol).all()),
          f"{name}: top-{k} S off by {float(err.max())} "
          f"(rtol 1e-3, atol 1e-3*S[0])")
    return dict(s0=float(s[0]), s_k=float(s[-1]), max_abs_dS=float(err.max()),
                max_rel_dS=float((err / s_ref).max()))


def phase_solve_randomized(state) -> None:
    """Rank-16 on the paper matrix, twice.  With the default sketch
    (oversample 8, 2 power passes) the paper matrix's slowly decaying
    spectrum (S[15] / S[24] is about 1.2) leaves the sketch itself several
    percent off in the lower of the 16 values, on any device; it is held to
    what a Rayleigh-Ritz sketch guarantees (never above the true value) and
    to 10 %.  With oversample 48 and 4 power passes (the tall-row settings of
    phase 7) it is held at rtol 1e-3, atol 1e-3 * S[0]."""
    coo = state["coo"]
    repaired = state["sparse_random_repair"]
    s_ref = reference_svals(repaired, NUM_BLOCKS).cpu().numpy()
    for oversample, power_iters, tight in ((8, 2, False), (48, 4, True)):
        cfg = api.SolveConfig(backend="single", method="random", rank=16,
                              oversample=oversample, power_iters=power_iters,
                              num_blocks=NUM_BLOCKS, want_right=True)
        res, counts = timed_svd(coo, cfg)
        name = f"solve_randomized[p={oversample},q={power_iters}]"
        keep_counts(state, name, counts)
        check(res.plan.strategy == "randomized"
              and res.plan.backend == "single", f"{name}: plan")
        passes = 1 + cfg.power_iters
        check(counts["sketch_panel"] == passes,
              f"{name}: sketch_panel launched {counts['sketch_panel']} "
              f"times, want {passes} (one per sketch pass, D is a grid axis)")
        check(res.u.shape == (coo.shape[0], 16)
              and res.v.shape == (coo.shape[1], 16), f"{name}: U/V shape")
        ortho = float((res.u.T @ res.u
                       - torch.eye(16, device=DEVICE)).abs().max())
        check(ortho <= 1e-4, f"{name}: |U^T U - I|_max {ortho}")
        if tight:
            fields = check_topk(name, res.s, s_ref, 16)
        else:
            s = res.s.double().cpu().numpy()
            rel = (s_ref[:16] - s) / s_ref[:16]
            check(np.isfinite(s).all() and rel.min() >= -1e-4
                  and rel.max() <= 0.10,
                  f"{name}: top-16 S outside [0.9, 1 + 1e-4] x reference "
                  f"(relative shortfall {rel.min()} .. {rel.max()})")
            fields = dict(s0=float(s[0]), s_k=float(s[-1]),
                          max_abs_dS=float(np.abs(s - s_ref[:16]).max()),
                          max_rel_dS=float(np.abs(rel).max()))
        res2, _ = timed_svd(coo, cfg)
        emit("solve_randomized", oversample=oversample,
             power_iters=power_iters,
             held_at=("rtol 1e-3, atol 1e-3*S[0]" if tight
                      else "0.9..1+1e-4 of the reference"),
             warm_wall_time_s=res2.diagnostics.wall_time_s, ortho_err=ortho,
             stage_ms=stage_ms(coo, cfg),
             **diag_fields(res, counts), **fields)


def host_repaired_csr(rep):
    """The repaired matrix as a scipy CSR (M, D*W), built on the host from
    the ELL arrays and the repair side-band alone."""
    import scipy.sparse as sp

    ell = rep.ell
    ids = ell.col_ids.cpu().numpy()
    rows = ell.col_rows.cpu().numpy()
    vals = ell.col_vals.cpu().numpy()
    rc = rep.repair_cols.cpu().numpy()
    rm = rep.repair_mask.cpu().numpy()
    d, c, k = rows.shape
    gcol = (np.arange(d)[:, None] * ell.width + ids)[:, :, None]
    gcol = np.broadcast_to(gcol, (d, c, k))
    keep = vals != 0
    r_d, r_r = np.nonzero(rm)
    all_rows = np.concatenate([rows[keep], r_r])
    all_cols = np.concatenate([gcol[keep], r_d * ell.width + rc[rm]])
    all_vals = np.concatenate([vals[keep], np.ones(r_r.size, np.float32)])
    return sp.csr_matrix((all_vals.astype(np.float64),
                          (all_rows, all_cols)),
                         shape=(ell.m, d * ell.width))


def scaled_coo(m, n, density, seed):
    coo = sparse.random_bipartite(m, n, density, seed=seed, power_law=True)
    return sparse.ensure_full_row_rank(coo, seed=seed)


def phase_solve_scaled(state) -> None:
    # (a) exact gram at M = 2048.
    m, n = SCALED_EXACT
    t0 = time.perf_counter()
    coo = scaled_coo(m, n, 5e-4, seed=11)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    ell = sparse.block_ell_from_coo(coo, NUM_BLOCKS, device=DEVICE)
    torch.cuda.synchronize()
    t_ell = time.perf_counter() - t0
    cfg = api.SolveConfig(num_blocks=NUM_BLOCKS, merge_mode="gram",
                          use_kernel=True)
    res, counts = timed_svd(coo, cfg)
    name = "solve_scaled[a]"
    keep_counts(state, name, counts)
    check(res.plan.backend == "single" and res.plan.strategy == "exact_gram",
          f"{name}: plan")
    check(counts["sparse_gram"] >= 1, f"{name}: sparse_gram was not launched")
    repaired = ranky.split_and_repair(ell, NUM_BLOCKS, cfg.method,
                                      cfg.resolved_key())
    fields = check_exact_result(name, res, repaired, NUM_BLOCKS, recon=False)
    res2, _ = timed_svd(ell, cfg)
    # The kernel at this shape: 0/1 (exact) and with seeded weights in
    # (0.5, 2) on the non-zero slots, each the same bits over 10 calls,
    # timed beside its bound and its plain version (phase ``kernels``'
    # timed_variants).
    main = state["kernel_main"]["sparse_gram"]
    w_vals = reweighted(ell.col_vals, 13)
    for tag, vals in (("0/1 (exact)", ell.col_vals),
                      ("weights in (0.5, 2)", w_vals)):
        case = f"{name} ({m} x {n}) {tag}, rows/vals " \
               f"{tuple(ell.col_rows.shape)}"
        kf = sparse_gram_case(state["kernel_cases"], case, ell.col_rows,
                              vals, m)
        b_ms, b_by = sparse_gram_bound(ell.col_rows, vals, m)
        kf.update(
            ms=time_ms(lambda: sg_mod.sparse_gram(ell.col_rows, vals, m),
                       iters=10),
            device_ms=device_ms(
                lambda: sg_mod.sparse_gram(ell.col_rows, vals, m)),
            plain_ms=time_ms(lambda: sg_mod.sparse_gram_ref(
                ell.col_rows, vals, m), iters=3, warmup=1),
            bound_ms=b_ms, bound_by=b_by,
            **sparse_gram_library(ell.col_rows, vals, m, iters=5),
            device_kernels=device_kernels_per_call(
                lambda: sg_mod.sparse_gram(ell.col_rows, vals, m)))
        main["timed_variants"].append(kf)
    del w_vals
    # right_vectors at the exact cell's shape (this solve's U and S, the
    # repaired ELL), then as the streaming merges call it: U's first 72
    # columns, S = 1, into columns 64-135 of a (D*W, 136) panel.
    rv_main = state["kernel_main"]["right_vectors"]
    for tag, u, s_, out_cols in (
            ("exact, U square", res.u, res.s, None),
            ("streaming merge, U[:, :72] into columns 64-135 of a (D*W, "
             "136) panel", res.u[:, :72], torch.ones(72, device=DEVICE),
             (136, 64))):
        rv_main["timed_variants"].append(right_vectors_timed(
            state["kernel_cases"], f"{name} ({m} x {n}) {tag}, U "
            f"{tuple(u.shape)}, rows/vals {tuple(ell.col_rows.shape)}",
            rv_args(repaired, u, s_), out_cols=out_cols))
        torch.cuda.empty_cache()
    del repaired
    emit("solve_scaled", case="a", m=m, n=n, nnz=coo.nnz,
         ell_capacity=list(ell.capacity), host_generate_s=t_gen,
         host_block_ell_from_coo_s=t_ell,
         warm_wall_time_s_ell_input=res2.diagnostics.wall_time_s,
         sparse_gram=main["timed_variants"][-2:],
         right_vectors=rv_main["timed_variants"][-2:],
         stage_ms=stage_ms(ell, cfg),
         **diag_fields(res, counts), **fields)
    del ell, res, res2
    torch.cuda.empty_cache()

    # (b) the tall-row case: the planner must choose the sketch.
    from scipy.sparse.linalg import svds

    m, n = SCALED_TALL
    t0 = time.perf_counter()
    coo = scaled_coo(m, n, 5e-4, seed=12)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    ell = sparse.block_ell_from_coo(coo, NUM_BLOCKS, device=DEVICE)
    torch.cuda.synchronize()
    t_ell = time.perf_counter() - t0
    cfg = api.SolveConfig(method="random", rank=16, oversample=48,
                          power_iters=4, num_blocks=NUM_BLOCKS)
    res, counts = timed_svd(coo, cfg)
    name = "solve_scaled[b]"
    keep_counts(state, name, counts)
    check(cfg.backend == "auto" and res.plan.backend == "single"
          and res.plan.strategy == "randomized", f"{name}: plan "
          f"{res.plan.backend}/{res.plan.strategy}")
    check(counts["sketch_panel"] == 1 + cfg.power_iters,
          f"{name}: sketch_panel launches {counts['sketch_panel']}")
    repaired = ranky.split_and_repair(ell, NUM_BLOCKS, cfg.method,
                                      cfg.resolved_key())
    t0 = time.perf_counter()
    s_ref = np.sort(svds(host_repaired_csr(repaired), k=16,
                         return_singular_vectors=False))[::-1]
    t_ref = time.perf_counter() - t0
    fields = check_topk(name, res.s, s_ref.copy(), 16)
    state["tall"] = dict(coo=coo, ell=ell, s_ref=s_ref.copy(),
                         method=cfg.method)
    res2, _ = timed_svd(ell, cfg)
    # The kernel at this shape (L = 64 = rank + oversample, K = 36 > 32),
    # with Omega as the solver passes it ((L, M) contiguous) and as the
    # transpose of an (M, L)-contiguous tensor (phase ``kernels``'
    # timed_variants).
    omega = torch.randn((64, m), device=DEVICE,
                        generator=torch.Generator(DEVICE).manual_seed(3))
    main = state["kernel_main"]["sketch_panel"]
    for layout, om in (("(L, M)", omega),
                       ("(M, L) transposed", omega.T.contiguous().T)):
        kf = sketch_timed(
            state["kernel_cases"], f"{name} ({m} x {n}) omega "
            f"{tuple(omega.shape)} {layout}, rows/vals "
            f"{tuple(ell.col_rows.shape)}", om, ell.col_rows, ell.col_vals)
        kf["plain_ms"] = time_ms(lambda: sp_mod.sketch_panel_ref(
            om, ell.col_rows, ell.col_vals), iters=3, warmup=1)
        main["timed_variants"].append(kf)
    emit("solve_scaled", case="b", m=m, n=n, nnz=coo.nnz,
         ell_capacity=list(ell.capacity), host_generate_s=t_gen,
         host_block_ell_from_coo_s=t_ell, host_scipy_svds_s=t_ref,
         warm_wall_time_s_ell_input=res2.diagnostics.wall_time_s,
         sketch_panel=main["timed_variants"][-2:],
         stage_ms=stage_ms(ell, cfg),
         **diag_fields(res, counts), **fields)


# ---------------------------------------------------------------------------
# topk_score: the kernel against its plain version (phase 3)
# ---------------------------------------------------------------------------

def topk_bound(qs, v, k_top, scale):
    """(bound_ms, bound_by, operations, bytes).  Bytes: v, the scale, the
    queries and the two outputs once; operations: a multiply and an add per
    (query, item, factor)."""
    b, k = qs.shape
    n = v.shape[0]
    nbytes = (v.numel() * v.element_size() + (n * 4 if scale is not None
                                               else 0)
              + qs.numel() * 4 + b * k_top * 8)
    return (*bound(nbytes, 2.0 * b * n * k), 2.0 * b * n * k, nbytes)


def topk_case(cases, case, qs, v, k_top, *, scale=None, valid_n=None,
              index_offset=0, block_n=512, plain_iters=5, passes=False):
    """Kernel vs plain version with torch.equal on values and indices, and
    the times: kernel, plain version, one library call (timed only: its tie
    order differs) and the bound; with ``passes``, the device time of each
    of the kernel's two passes (``torch.profiler``)."""
    kw = dict(scale=scale, valid_n=valid_n, index_offset=index_offset)
    got = tk_mod.topk_score(qs, v, k_top, block_n=block_n, **kw)
    want = tk_mod.topk_score_ref(qs, v, k_top, **kw)
    torch.cuda.synchronize()
    equal = bool(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]))
    err = max_err(got[0], want[0])
    cases.append(dict(kernel="topk_score", case=case, equal=equal,
                      max_abs_err=err, limit=0.0))
    check(equal, f"topk_score[{case}]: differs from the plain version "
          f"(max |dv| {err}, {int((got[1] != want[1]).sum())} indices)")
    def library():
        s = torch.mm(qs, v.float().T)
        return torch.topk(s * scale[None, :] if scale is not None else s,
                          k_top)

    b_ms, b_by, flops, nbytes = topk_bound(qs, v, k_top, scale)
    call = lambda: tk_mod.topk_score(qs, v, k_top, block_n=block_n,  # noqa
                                     **kw)
    ms = time_ms(call)
    return dict(
        case=case, shape=f"qs {tuple(qs.shape)}, v {tuple(v.shape)} "
                         f"{str(v.dtype).replace('torch.', '')}, "
                         f"k_top {k_top}",
        max_abs_err=err, ms=ms,
        plain_ms=time_ms(lambda: tk_mod.topk_score_ref(qs, v, k_top, **kw),
                         iters=plain_iters, warmup=1),
        bound_ms=b_ms, bound_by=b_by, **achieved(flops, nbytes, ms),
        library_ms=time_ms(library, iters=5, warmup=1),
        device_kernels=device_kernels_per_call(call),
        **(dict(pass_ms=device_ms_by_kernel(call)) if passes else {}))


def topk_variants(cases, b, k, n, k_top, *, n_valid, seed, plain_iters):
    """The five variants at one shape: f32; int8 + kvquant scale; valid_n <
    N with an index offset; a ragged last tile; all scores tied three ways."""
    gen = torch.Generator(DEVICE).manual_seed(seed)
    qs = torch.randn((b, k), generator=gen, device=DEVICE)
    v = torch.randn((n, k), generator=gen, device=DEVICE)
    tag = f"B={b} k={k} N={n}"
    rows = [topk_case(cases, f"{tag} f32, valid_n={n_valid}", qs, v, k_top,
                      valid_n=n_valid, plain_iters=plain_iters, passes=True)]
    v_q, v_scale = kvquant.quantize(v, axis=-1)
    rows.append(topk_case(cases, f"{tag} int8 + kvquant scale", qs, v_q,
                          k_top, scale=v_scale[:, 0].contiguous(),
                          valid_n=n_valid, plain_iters=plain_iters,
                          passes=True))
    rows.append(topk_case(cases, f"{tag} valid_n={n - 3001} offset=5000", qs,
                          v, k_top, valid_n=n - 3001, index_offset=5000,
                          plain_iters=plain_iters))
    n_rag = n - 37
    rows.append(topk_case(cases, f"{tag} ragged N={n_rag} block_n=128", qs,
                          v[:n_rag], k_top, block_n=128,
                          plain_iters=plain_iters))
    qi = torch.randint(-3, 4, (b, k), generator=gen, device=DEVICE).float()
    base = torch.randint(-3, 4, (n // 3, k), generator=gen,
                         device=DEVICE).float()
    rows.append(topk_case(cases, f"{tag} all ties (integer rows x 3)", qi,
                          base.repeat(3, 1), k_top, plain_iters=plain_iters))
    return rows


def topk_kernel_rows(state, cases, main) -> None:
    ell = state["ell"]
    n_pad = ell.num_blocks * ell.width
    paper = topk_variants(cases, TOPK_PAPER["b"], TOPK_PAPER["k"], n_pad,
                          TOPK_PAPER["k_top"], n_valid=ell.n, seed=11,
                          plain_iters=5)
    sc = SCALED_SERVE
    scaled = topk_variants(cases, sc["b"], sc["rank"], sc["n"], sc["k_top"],
                           n_valid=sc["n"], seed=12, plain_iters=2)
    torch.cuda.empty_cache()
    main["topk_score"] = dict(paper[0], variants=paper[1:],
                              scaled_shape=scaled)
    before = tk_mod.launches
    e_v, e_i = tk_mod.topk_score(torch.empty((0, 16), device=DEVICE),
                                 torch.ones((40, 16), device=DEVICE), 10)
    check(e_v.shape == e_i.shape == (0, 10) and tk_mod.launches == before,
          "topk_score: an empty wave must return (0, k_top) and launch "
          "nothing")


# ---------------------------------------------------------------------------
# Phases 8-10: streaming ingest and top-k serving
# ---------------------------------------------------------------------------

def coo_rows(coo, lo: int, hi: int) -> sparse.COOMatrix:
    """Rows [lo, hi) of a COO matrix, in the same column universe."""
    sel = (coo.rows >= lo) & (coo.rows < hi)
    return sparse.COOMatrix(rows=(coo.rows[sel] - lo).astype(np.int32),
                            cols=coo.cols[sel], vals=coo.vals[sel],
                            shape=(hi - lo, coo.shape[1]))


def ortho_err(x) -> float:
    return float((x.T @ x - torch.eye(x.shape[1], device=x.device))
                 .abs().max())


def sum_stages(rec) -> dict:
    """{span or "span xn": total ms} of a :class:`SpanRecord`, from its
    ``obs.span_summary``."""
    return {(f"{name} x{count}" if count > 1 else name): total_us / 1e3
            for name, count, total_us in rec.summary}


def stream_gram_case(cases, tag, st, delta, cfg, draws=None) -> None:
    """sparse_gram against its plain version on the repaired blocks that
    the ingest of ``delta`` into ``st`` factors (the same repair, key and
    draws): exact for 0/1 data, else 1e-5 * max|plain|."""
    blocks = ranky.split_and_repair(
        stream_state.as_delta(delta, st), st.num_blocks, cfg.method,
        ranky.derive_seed(st.seed, st.batches_seen), draws=draws)
    ell = blocks.ell
    zero_one = bool(((ell.col_vals == 0) | (ell.col_vals == 1)).all())
    compare("sparse_gram",
            sg_mod.sparse_gram(ell.col_rows, ell.col_vals, ell.m),
            sg_mod.sparse_gram_ref(ell.col_rows, ell.col_vals, ell.m),
            0.0 if zero_one else 1e-5, cases,
            f"{tag}: repaired batch, rows/vals {tuple(ell.col_rows.shape)}, "
            f"M={ell.m}, {'0/1 (exact)' if zero_one else 'weighted'}")


def phase_stream_exact(state) -> None:
    """The paper matrix in 4 row batches with the rank kept in full: the
    stream is exact, so S is held against float64 like a one-shot solve."""
    coo = state["coo"]
    m, n = coo.shape
    cfg = api.SolveConfig(method="none", truncate_rank=m,
                          num_blocks=NUM_BLOCKS, use_kernel=True,
                          want_right=True)
    st = api.svd_init(n, cfg, device=DEVICE)
    bounds = np.linspace(0, m, 5).astype(int)
    walls, merge_ms, per_batch, befores = [], [], [], []
    reset_counts()
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        befores.append(st)
        with spans() as rec:
            res = api.svd_update(st, coo_rows(coo, int(lo), int(hi)), cfg)
        st = res.state
        walls.append(res.diagnostics.wall_time_s)
        merge_ms.append(rec.times["merge.svd"][0])
        per_batch.append(sum_stages(rec))
        check(res.plan.backend == "single" and res.plan.strategy ==
              "streaming" and res.plan.rank is None, "stream_exact: plan")
    counts = read_counts()
    keep_counts(state, "stream_exact", counts)
    check(counts["sparse_gram"] == 4, f"stream_exact: sparse_gram launches "
          f"{counts['sparse_gram']}, want one per batch")
    check(st.rank == m and st.rows_seen == m, "stream_exact: rank/rows")
    s_ref = reference_svals(ranky.split_and_repair(state["ell"], NUM_BLOCKS,
                                                   "none"), NUM_BLOCKS)
    ds = (st.s.double() - s_ref).abs()
    limit = 2e-3 * float(s_ref[0])
    check(float(ds.max()) <= limit,
          f"stream_exact: max|dS| {float(ds.max())} > 2e-3*S[0] = {limit}")
    u_err, v_err = ortho_err(st.u), ortho_err(st.v)
    check(u_err <= 1e-4 and v_err <= 1e-4,
          f"stream_exact: |U^T U - I| {u_err}, |V^T V - I| {v_err}")
    gram_cases = []
    for b, (before, lo, hi) in enumerate(zip(befores, bounds[:-1],
                                              bounds[1:])):
        stream_gram_case(gram_cases, f"stream_exact batch {b}", before,
                         coo_rows(coo, int(lo), int(hi)), cfg)
    emit("stream_exact", batches=[int(b) for b in np.diff(bounds)],
         merge_driver=hierarchy.CUDA_SVD_DRIVER or "default",
         wall_time_s=walls, merge_svd_ms=merge_ms, stage_ms=per_batch,
         s0=float(st.s[0]), s_last=float(st.s[-1]), max_abs_dS=float(ds.max()),
         dS_limit=limit, u_ortho_err=u_err, v_ortho_err=v_err,
         kernel_checks=gram_cases, launches=counts)


def port_draws(seed: int, method: str, ell) -> ranky.RepairDraws:
    """The repair draws the port makes for this batch on the CPU, moved to
    the GPU: its CUDA generator would draw other neighbor scores, and the GPU
    stream is held against the CPU one."""
    d, m, w, c = ell.num_blocks, ell.m, ell.width, ell.capacity[0]
    rc = ranky.draw_random_cols(seed, method, d, m, w, "cpu")
    sc = torch.stack([ranky.draw_neighbor_scores(seed, method, i, (m, c),
                                                 "cpu") for i in range(d)])
    return ranky.RepairDraws(rc.to(DEVICE), sc.to(DEVICE))


def expected_wave(snap, queries, k_top):
    """The plain version's answer on one snapshot, on the host."""
    qs = ranker.fold_queries(snap, queries.to(snap.device))
    if snap.quantized:
        out = tk_mod.topk_score_ref(qs, snap.v_q, k_top,
                                    scale=snap.v_scale[:, 0].contiguous(),
                                    valid_n=snap.n)
    else:
        out = tk_mod.topk_score_ref(qs, snap.v, k_top, valid_n=snap.n)
    return out[0].cpu(), out[1].cpu()


def same(res, want) -> bool:
    return (torch.equal(res.scores.cpu(), want[0])
            and torch.equal(res.indices.cpu(), want[1]))


def phase_stream_serve(state) -> None:
    """The user's configuration: the paper rows streamed in batches of 64,
    rank 16, served in waves of 32 while later batches are ingested."""
    import threading

    coo = state["coo"]
    m, n = coo.shape
    cfg = api.SolveConfig(method="neighbor_random", truncate_rank=16,
                          oversample=8, num_blocks=NUM_BLOCKS,
                          use_kernel=True)
    bounds = list(range(0, m, STREAM_BATCH_ROWS)) + [m]
    batches = [coo_rows(coo, lo, hi) for lo, hi in zip(bounds, bounds[1:])]
    nb = len(batches)

    # The same stream on the CPU, with the port's own draws.
    t0 = time.perf_counter()
    st_cpu = api.svd_init(n, cfg, device="cpu")
    for delta in batches:
        st_cpu = api.svd_update(st_cpu, delta, cfg).state
    cpu_s = time.perf_counter() - t0

    def draws_for(st, delta):
        ell = sparse.block_ell_from_coo(delta, NUM_BLOCKS, device="cpu")
        return port_draws(ranky.derive_seed(st.seed, st.batches_seen),
                          cfg.method, ell)

    st0 = st = api.svd_init(n, cfg, device=DEVICE)
    reset_counts()
    warm = []
    for delta in batches[:4]:
        res = api.svd_update(st, delta, cfg, draws=draws_for(st, delta))
        st = res.state
        warm.append(res.diagnostics.wall_time_s)
    keep_counts(state, "stream_serve[ingest x4]", read_counts())
    gram_cases = []
    for b, before in ((0, st0), (4, st)):
        stream_gram_case(gram_cases, f"stream_serve batch {b}", before,
                         batches[b], cfg, draws_for(before, batches[b]))
    with spans() as rec:     # one more ingest, off the main path
        api.svd_update(st, batches[4], cfg, draws=draws_for(st, batches[4]))
    ingest_stages = sum_stages(rec)

    h32 = api.serve_init(st, api.ServeTopKConfig(batch_size=32, k_top=10))
    h8 = api.serve_init(st, api.ServeTopKConfig(batch_size=32, k_top=10,
                                                quantize=True))
    check(h32.plan.backend == "single" and h32.plan.strategy == "serve_fused",
          "stream_serve: R7 plan")
    gen = torch.Generator(DEVICE).manual_seed(5)
    q = torch.randn((32, 16), generator=gen, device=DEVICE)
    reset_counts()
    r32 = api.serve_topk(h32, q)
    counts = read_counts()
    keep_counts(state, "serve_topk[f32]", counts)
    check(counts["topk_score"] == 1, "serve_topk[f32]: topk_score launches "
          f"{counts['topk_score']}")
    reset_counts()
    r8 = api.serve_topk(h8, q)
    keep_counts(state, "serve_topk[int8]", read_counts())
    check(same(r32, expected_wave(h32.read(), q, 10)),
          "serve_topk[f32] differs from the plain version")
    check(same(r8, expected_wave(h8.read(), q, 10)),
          "serve_topk[int8] differs from the plain version")
    i32, i8 = r32.indices.cpu().tolist(), r8.indices.cpu().tolist()
    overlap = float(np.mean([len(set(a) & set(b)) / 10
                             for a, b in zip(i32, i8)]))
    with spans() as rec:
        api.serve_topk(h32, q)
    wave_stages = sum_stages(rec)
    # Cold start: raw interaction rows projected into factor space.
    raw = torch.from_numpy(coo_rows(coo, 0, 8).todense()).to(DEVICE)
    cold_q = ranker.project_rows(h32.read(), raw)
    cold = api.serve_topk(h32, cold_q)
    check(torch.isfinite(cold_q).all() and cold.indices.shape == (8, 10)
          and same(cold, expected_wave(h32.read(), cold_q, 10)),
          "stream_serve: cold-start wave")

    def serve_waves(count=None, until=None):
        """Answer waves of ``q`` on h32 until ``count`` waves are done or
        ``until`` is set (and at least 50 waves); (waves, seconds)."""
        out = []
        t_start = time.perf_counter()
        while (len(out) < count if count is not None
               else not until.is_set() or len(out) < 50):
            t1 = time.perf_counter()
            res = api.serve_topk(h32, q)
            torch.cuda.current_stream().synchronize()
            lat = time.perf_counter() - t1
            out.append((res, lat, h32.metrics()["snapshot_age_s"],
                        until is not None and not until.is_set()))
        return out, time.perf_counter() - t_start

    def wave_stats(waves, seconds):
        lat_ms = np.array([w[1] for w in waves]) * 1e3
        return dict(waves=len(waves), waves_per_s=len(waves) / seconds,
                    p50_wave_ms=float(np.percentile(lat_ms, 50)),
                    p99_wave_ms=float(np.percentile(lat_ms, 99)))

    # The same waves with no ingest beside them: the baseline of the live
    # numbers below.
    idle = wave_stats(*serve_waves(count=200))

    # Serve under ingest: batches 4.. on a stream of their own, committed
    # between waves.  The snapshot each commit publishes is kept; the
    # answers every version should give are computed after the live window,
    # so that no check runs beside the timed waves and ingests.
    snaps = {h32.version: h32.read()}
    ingest_stream = torch.cuda.Stream()
    done = threading.Event()
    errors, update_ms, commit_ms, final = [], [], [], {}

    def ingest_loop():
        try:
            with torch.cuda.stream(ingest_stream):
                s = st
                for delta in batches[4:]:
                    final["before_last"] = s
                    res = api.svd_update(s, delta, cfg,
                                         draws=draws_for(s, delta))
                    t1 = time.perf_counter()
                    snap = h32.commit(res.state)
                    commit_ms.append((time.perf_counter() - t1) * 1e3)
                    update_ms.append(res.diagnostics.wall_time_s * 1e3)
                    snaps[snap.version] = snap
                    s = res.state
                final["state"] = s
        except Exception as exc:       # reported by the main thread
            errors.append(repr(exc))
        finally:
            done.set()

    worker = threading.Thread(target=ingest_loop, daemon=True)
    worker.start()
    waves, live_s = serve_waves(until=done)
    worker.join(timeout=600)
    check(not worker.is_alive() and not errors,
          f"stream_serve: ingest thread {errors or 'did not finish'}")
    expected = {ver: expected_wave(snap, q, 10) for ver, snap in snaps.items()}
    bad = [res.version for res, *_ in waves
           if not same(res, expected[res.version])]
    check(not bad, f"stream_serve: {len(bad)} waves differ from the answer "
          f"for their version (versions {sorted(set(bad))})")
    versions = sorted({w[0].version for w in waves})
    check(len(versions) > 1, "stream_serve: no wave saw a new version")
    stream_gram_case(gram_cases, f"stream_serve batch {nb - 1} (ragged)",
                     final["before_last"], batches[-1], cfg,
                     draws_for(final["before_last"], batches[-1]))

    st_gpu = final["state"]
    ds = float((st_gpu.s.cpu() - st_cpu.s).abs().max())
    check(ds <= 1e-3 * float(st_cpu.s[0]),
          f"stream_serve: GPU vs CPU max|dS| {ds}")
    u_err, v_err = ortho_err(st_gpu.u), ortho_err(st_gpu.v)
    check(u_err <= 1e-4 and v_err <= 1e-4,
          f"stream_serve: |U^T U - I| {u_err}, |V^T V - I| {v_err}")
    check((st_gpu.lonely_rows_seen, st_gpu.repaired_rows_seen)
          == (st_cpu.lonely_rows_seen, st_cpu.repaired_rows_seen),
          "stream_serve: lonely / repaired counts differ from the CPU run")
    state["stage_summary"] = dict(ingest=ingest_stages, serve_wave=wave_stages)
    emit("stream_serve", batches=nb, batch_rows=STREAM_BATCH_ROWS,
         first_ingest_wall_s=warm[0], warm_ingest_wall_s=warm[1:],
         cpu_stream_s=cpu_s, s0=float(st_gpu.s[0]), s15=float(st_gpu.s[-1]),
         max_abs_dS_vs_cpu=ds, u_ortho_err=u_err, v_ortho_err=v_err,
         lonely_rows=st_gpu.lonely_rows_seen,
         repaired_rows=st_gpu.repaired_rows_seen,
         int8_f32_top10_overlap=overlap,
         cold_start_wave_ok=True, ingest_stage_ms=ingest_stages,
         wave_stage_ms=wave_stages, kernel_checks=gram_cases,
         no_ingest=idle,
         live=dict(wave_stats(waves, live_s),
                   waves_during_ingest=sum(w[3] for w in waves),
                   versions_seen=versions,
                   svd_update_ms=update_ms, commit_ms=commit_ms,
                   snapshot_age_s_max=max(w[2] for w in waves)),
         clocks="waves: host clock around serve_topk, the serving stream "
                "synchronized; svd_update_ms: its own wall_time_s (the "
                "whole device synchronized at both ends, so it also waits "
                "for waves in flight); commit_ms: host clock around "
                "handle.commit (snapshot, ingest-stream synchronize, "
                "publish)")


def phase_serve_scaled(state) -> None:
    """A catalogue of 1,048,576 items at rank 64, served in waves of 256."""
    sc = SCALED_SERVE
    n = sc["n"]
    cfg = api.SolveConfig(method="neighbor_random", truncate_rank=sc["rank"],
                          num_blocks=NUM_BLOCKS, use_kernel=True)
    st = api.svd_init(n, cfg, device=DEVICE)
    ingest_s, ingested = [], []
    deltas = [sparse.random_bipartite(sc["rows"], n, sc["density"],
                                      seed=31 + b, power_law=True)
              for b in range(sc["batches"])]
    reset_counts()
    for delta in deltas:
        ingested.append((st, delta))
        res = api.svd_update(st, delta, cfg)
        st = res.state
        ingest_s.append(res.diagnostics.wall_time_s)
    counts = read_counts()
    keep_counts(state, f"serve_scaled[ingest x{sc['batches']}]", counts)
    check(st.rank == sc["rank"] and torch.isfinite(st.s).all(),
          "serve_scaled: state")
    check(counts["sparse_gram"] == sc["batches"], "serve_scaled: sparse_gram "
          f"launches {counts['sparse_gram']}, want one per batch")
    gram_cases = []
    for b, (before, delta) in enumerate(ingested):
        stream_gram_case(gram_cases, f"serve_scaled batch {b}", before,
                         delta, cfg)
    del ingested
    torch.cuda.empty_cache()
    gen = torch.Generator(DEVICE).manual_seed(6)
    q = torch.randn((sc["b"], sc["rank"]), generator=gen, device=DEVICE)
    out = {}
    for name, quant in (("f32", False), ("int8", True)):
        h = api.serve_init(st, api.ServeTopKConfig(
            batch_size=sc["b"], k_top=sc["k_top"], quantize=quant))
        reset_counts()
        res = api.serve_topk(h, q)
        keep_counts(state, f"serve_scaled[{name}]", read_counts())
        check(same(res, expected_wave(h.read(), q, sc["k_top"])),
              f"serve_scaled[{name}]: differs from the plain version")
        snap = h.read()
        qs = ranker.fold_queries(snap, q)
        v = snap.v_q if quant else snap.v
        scale = snap.v_scale[:, 0].contiguous() if quant else None
        b_ms, b_by, _, _ = topk_bound(qs, v, sc["k_top"], scale)
        out[name] = dict(
            wave_ms=time_ms(lambda: api.serve_topk(h, q)),
            ms=time_ms(lambda: tk_mod.topk_score(qs, v, sc["k_top"],
                                                 scale=scale, valid_n=n)),
            plain_ms=time_ms(lambda: tk_mod.topk_score_ref(
                qs, v, sc["k_top"], scale=scale, valid_n=n), iters=2,
                warmup=1),
            library_ms=time_ms(lambda: torch.topk(
                torch.mm(qs, v.float().T) * (scale[None, :] if quant else 1.0),
                sc["k_top"]), iters=5, warmup=1),
            bound_ms=b_ms, bound_by=b_by, plan_peak_bytes=h.plan.peak_bytes)
        del h, snap, res
    emit("serve_scaled", n=n, rank=sc["rank"], batches=sc["batches"],
         batch_rows=sc["rows"], density=sc["density"],
         ingest_wall_s=ingest_s, s0=float(st.s[0]), s_last=float(st.s[-1]),
         kernel_checks=gram_cases, waves=out)
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 10b: the hierarchical tree merge (backend="hierarchical", rule R2)
# ---------------------------------------------------------------------------

def tree_fields(name, res, counts, want) -> dict:
    """The launch checks of one tree solve: ``want`` maps each kernel to
    the launches the solve must make (every other kernel: none)."""
    for kname, n in counts.items():
        check(n == want.get(kname, 0),
              f"{name}: {kname} launched {n} times, want "
              f"{want.get(kname, 0)}")
    check(res.plan.backend == "hierarchical", f"{name}: backend "
          f"{res.plan.backend}")
    return diag_fields(res, counts)


def phase_hierarchical(state) -> None:
    """The tree merge on the card: the paper matrix exact (r = M) from COO
    (``sparse_gram`` leaves) and dense input (``blockgram`` leaves), D = 8,
    fanout 4 (two levels), with right vectors; the same at rank 16 against
    the same inputs and draws run on the CPU; rule R2 (``sketch=True``,
    rank 16) on the tall 32,768 x 262,144 matrix of phase 7b
    (``sketch_panel`` leaves, one launch a pass over the whole stack), held
    like phase 6's default sketch.  The tree's wide (539, 4 x 539) group
    panels are merged on ``gesvd`` through their transpose; the exact
    sparse tree is also run under torch's default driver (``gesvdj``) for
    the record (``wide_merge_driver_ab``)."""
    coo, ell = state["coo"], state["ell"]
    m, n = coo.shape
    out = {}
    base = dict(backend="hierarchical", method="neighbor_random",
                num_blocks=NUM_BLOCKS, fanout=4, use_kernel=True,
                want_right=True)
    for kind, inp, kernel in (("exact sparse", coo, "sparse_gram"),
                              ("exact dense", coo.todense(), "blockgram")):
        cfg = api.SolveConfig(**base)
        res, counts = timed_svd(inp, cfg)
        name = f"hierarchical[{kind}]"
        # the repair the solve made (the dense and the sparse checkers draw
        # their neighbor scores over different candidate sets)
        repaired = ranky.split_and_repair(
            ell if kernel == "sparse_gram"
            else api.as_block_input(inp, NUM_BLOCKS, device=DEVICE),
            NUM_BLOCKS, cfg.method, cfg.resolved_key())
        keep_counts(state, name, counts)
        # V of a sparse stack: one right_vectors launch over the stack
        fields = tree_fields(name, res, counts, {
            kernel: 1, "right_vectors": int(kernel == "sparse_gram")})
        check(res.s.shape == (m,) and res.v.shape == (n, m),
              f"{name}: S / V shape")
        fields.update(check_exact_result(name, res, repaired, NUM_BLOCKS))
        v_err = ortho_err(res.v)
        check(v_err <= 1e-4, f"{name}: |V^T V - I|_max {v_err} > 1e-4")
        res2, _ = timed_svd(inp, cfg)
        out[kind] = dict(v_ortho_err=v_err,
                         warm_wall_time_s=res2.diagnostics.wall_time_s,
                         stage_ms=stage_ms(inp, cfg), **fields)
        del res, res2, repaired
    # The wide group panels under each driver (exact sparse tree).
    committed = hierarchy.CUDA_SVD_DRIVER
    ab = {}
    try:
        for drv in (None, "gesvd"):
            hierarchy.CUDA_SVD_DRIVER = drv
            with spans() as rec:
                r = api.svd(coo, api.SolveConfig(**base))
            ab[drv or "default"] = dict(
                u_ortho_err=ortho_err(r.u), v_ortho_err=ortho_err(r.v),
                merge_svd_ms=rec.times["merge.svd"])
    finally:
        hierarchy.CUDA_SVD_DRIVER = committed
    out["wide_merge_driver_ab"] = ab

    # Rank 16 (truncated leaves and merges), GPU against CPU on the same
    # inputs and the port's CPU draws.
    cfg16 = api.SolveConfig(**{**base, "rank": 16})
    draws = port_draws(cfg16.resolved_key(), cfg16.method,
                       sparse.block_ell_from_coo(coo, NUM_BLOCKS,
                                                 device="cpu"))
    res, counts = timed_svd(coo, cfg16, draws=draws)
    name = "hierarchical[rank 16]"
    keep_counts(state, name, counts)
    fields = tree_fields(name, res, counts, {"sparse_gram": 1,
                                             "right_vectors": 1})
    t0 = time.perf_counter()
    cpu = api.svd(coo, cfg16, device="cpu",
                  draws=ranky.RepairDraws(draws.random_cols.cpu(),
                                          draws.neighbor_scores.cpu()))
    cpu_s = time.perf_counter() - t0
    ds = float((res.s.cpu() - cpu.s).abs().max())
    check(res.s.shape == (16,) and torch.isfinite(res.s).all()
          and ds <= 1e-3 * float(cpu.s[0]),
          f"{name}: GPU vs CPU max|dS| {ds} > 1e-3*S[0]")
    u_err = ortho_err(res.u)
    check(u_err <= 1e-4, f"{name}: |U^T U - I| {u_err}")
    out["rank 16"] = dict(max_abs_dS_vs_cpu=ds, dS_limit=1e-3 * float(
        cpu.s[0]), u_ortho_err=u_err, cpu_solve_s=cpu_s, s0=float(res.s[0]),
        s15=float(res.s[-1]), **fields)
    del res, cpu

    # Rule R2: sketch leaves on the tall matrix.
    tall = state.pop("tall")
    cfg_r2 = api.SolveConfig(sketch=True, rank=16, method=tall["method"],
                             num_blocks=NUM_BLOCKS)
    res, counts = timed_svd(tall["coo"], cfg_r2)
    name = "hierarchical[R2 sketch]"
    keep_counts(state, name, counts)
    passes = 1 + cfg_r2.power_iters
    fields = tree_fields(name, res, counts, {"sketch_panel": passes})
    check(res.plan.sketch_leaves and res.plan.reasons[0].startswith("R2"),
          f"{name}: plan {res.plan.reasons}")
    # Each leaf keeps its block's top 16 only, so the tree's S is never
    # above the truth (every truncation is a projection) but its lower
    # values lose what the leaves dropped, however accurate the sketch
    # (the reference's tree has the same form).  So it is held at S[0] and
    # never above the truth, and to the same solve on the CPU (the same
    # key: the same draws and Omega).
    s = res.s.double().cpu().numpy()
    s_ref = tall["s_ref"]
    rel = (s_ref[:16] - s) / s_ref[:16]
    check(np.isfinite(s).all() and rel.min() >= -1e-4 and rel[0] <= 1e-3,
          f"{name}: top-16 S above the reference or S[0] off by more than "
          f"1e-3 (relative shortfall {rel.min()} .. {rel.max()})")
    t0 = time.perf_counter()
    cpu = api.svd(tall["ell"].to("cpu"), cfg_r2, device="cpu")
    cpu_s = time.perf_counter() - t0
    ds = float((res.s.cpu() - cpu.s).abs().max())
    check(ds <= 1e-3 * float(cpu.s[0]),
          f"{name}: GPU vs CPU max|dS| {ds} > 1e-3*S[0]")
    u_err = ortho_err(res.u)
    check(u_err <= 1e-4, f"{name}: |U^T U - I| {u_err}")
    res2, _ = timed_svd(tall["ell"], cfg_r2)
    out["R2 sketch"] = dict(
        m=tall["coo"].shape[0], n=tall["coo"].shape[1],
        oversample=cfg_r2.oversample, power_iters=cfg_r2.power_iters,
        held_at="S never above the reference (scipy svds) by 1e-4, S[0] "
                "within 1e-3 of it; GPU vs CPU within 1e-3*S[0]",
        s0=float(s[0]), s15=float(s[-1]), s_ref15=float(s_ref[15]),
        max_rel_shortfall=float(rel.max()), max_abs_dS_vs_cpu=ds,
        cpu_solve_s=cpu_s, u_ortho_err=u_err,
        warm_wall_time_s_ell_input=res2.diagnostics.wall_time_s,
        stage_ms=stage_ms(tall["ell"], cfg_r2), **fields)
    del res, res2, tall
    torch.cuda.empty_cache()
    emit("hierarchical", fanout=4, num_blocks=NUM_BLOCKS,
         merge_driver=hierarchy.CUDA_SVD_DRIVER or "default", **out)


# ---------------------------------------------------------------------------
# Phase 10c: the scan-window stream driver (svd_stream, rule R6)
# ---------------------------------------------------------------------------

# The catalogue stream: 1,048,576 items, D = 8, rank 64, one batch that
# grows the rank and 48 more of 1,000-1,024 rows (the 1,024-row bucket) at
# density 5e-4; a 16 GiB budget lets R6 pick a window (its closed form
# charges every batch a dense-sized repair transient).  The paper's rows
# in dense batches of 50-64 rows at rank 16.
STREAM_WINDOW = dict(n=1_048_576, rank=64, batches=48, rows=(1000, 1024),
                     density=5e-4, budget=16 << 30)
PAPER_WINDOW = dict(rank=16, rows=(50, 64))


def sync_site(stack) -> str:
    """"file:line" of a host sync, relative to the checkout: the innermost
    frame of the port's package (a sync raised inside one of torch's own
    Python functions, such as ``torch.unique``, is the port's call of it),
    else the innermost frame."""
    port = os.path.join(ROOT, "src", "repro_torch") + os.sep
    stack = [f for f in stack
             if os.path.basename(f.filename) != "warnings.py"]
    frame = next((f for f in reversed(stack)
                  if os.path.abspath(f.filename).startswith(port)),
                  stack[-1])
    return f"{os.path.relpath(frame.filename, ROOT)}:{frame.lineno}"


def sync_sites(fn):
    """(result, {"file:line": count}) of the host syncs ``fn()`` makes, as
    torch's sync debug mode reports them (sites as ``sync_site`` reads
    them)."""
    import traceback
    import warnings

    sites = {}

    def record(message, *args, **kwargs):
        if "synchroniz" in str(message):
            where = sync_site(traceback.extract_stack()[:-1])
            sites[where] = sites.get(where, 0) + 1

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, sites


def stream_of(batches, cfg):
    """svd_stream over ``batches``: its result."""
    return api.svd_stream(iter(batches), cfg, device=DEVICE)


def update_loop(batches, cfg):
    """svd_init and one svd_update a batch: the final state."""
    st = api.svd_init(batches[0].shape[1], cfg, device=DEVICE)
    for b in batches:
        st = api.svd_update(st, b, cfg).state
    return st


def counted(state, label, fn):
    """(fn(), host seconds), the device synchronized at both ends, with the
    launch counts of the call kept under ``label``."""
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    keep_counts(state, label, read_counts())
    return out, secs


def stream_case(state, name, batches, cfg, kernel) -> dict:
    """One stream three ways: ``svd_stream`` with the R6 window, with
    ``window=1`` (torch.equal to each other) and a plain ``svd_update``
    loop (within 1e-3 * S[0]); the syncs of one window and of its batches
    one by one; the measured peak of one window against R6's closed form."""
    from repro_torch.stream import window as sw

    loop_cfg = dataclasses.replace(cfg, window=1)
    sw.clear_caches()
    auto, auto_s = counted(state, f"stream_window[{name} window]",
                           lambda: stream_of(batches, cfg))
    counts_auto = sw.dispatch_counts()
    sw.clear_caches()
    loop, loop_s = counted(state, f"stream_window[{name} window=1]",
                           lambda: stream_of(batches, loop_cfg))
    counts_loop = sw.dispatch_counts()
    sw.clear_caches()
    upd, upd_s = counted(state, f"stream_window[{name} svd_update]",
                         lambda: update_loop(batches, cfg))
    # The three again in the opposite order (timing only): the first run of
    # a mode pays first-use costs (pinned host buffers, library workspaces).
    again = {}
    for mode, fn in (("svd_update", lambda: update_loop(batches, cfg)),
                     ("loop", lambda: stream_of(batches, loop_cfg)),
                     ("window", lambda: stream_of(batches, cfg))):
        _, again[mode] = counted({}, mode, fn)
    nb = len(batches) - 1                          # after the growth batch
    check(auto.plan.window > 1, f"{name}: R6 chose window "
          f"{auto.plan.window} ({auto.plan.reasons[-1]})")
    for f in ("u", "s", "v"):
        a, b = getattr(auto.state, f), getattr(loop.state, f)
        check(torch.equal(a, b), f"{name}: window=auto and window=1 differ "
              f"in {f} by {max_err(a, b)}")
    ds = float((auto.s - upd.s).abs().max())
    check(ds <= 1e-3 * float(upd.s[0]), f"{name}: window vs svd_update "
          f"max|dS| {ds} > 1e-3*S[0]")
    check((auto.state.lonely_rows_seen, auto.state.repaired_rows_seen)
          == (upd.lonely_rows_seen, upd.repaired_rows_seen),
          f"{name}: lonely / repaired counts differ from svd_update")
    for label in (f"stream_window[{name} window]",
                  f"stream_window[{name} window=1]"):
        got = state["launches_by_solve"][label][kernel]
        check(got == len(batches), f"{label}: {kernel} launched {got} "
              f"times, want one per batch ({len(batches)})")
    u_err, v_err = ortho_err(auto.state.u), ortho_err(auto.state.v)
    check(u_err <= 1e-4 and v_err <= 1e-4,
          f"{name}: |U^T U - I| {u_err}, |V^T V - I| {v_err}")

    # One more window from the final state (the batches again, one bucket,
    # the plan's length): host syncs, peak memory against R6.
    st = auto.state
    norm = [stream_state.as_delta(b, st, device="cpu") for b in batches[1:]]
    sig = sw.bucket_signature(norm[0])
    group = [x for x in norm if sw.bucket_signature(x) == sig]
    spec = api.ASpec(m=sig[1], n=st.n, nnz=api._delta_nnz_estimate(group[0]),
                     num_blocks=st.num_blocks, kind="stream")
    slots = sw.bucket_nnz_slots(sig, st.num_blocks)
    plan = api.planner.make_window_plan(spec, cfg, nnz_slots=slots)
    group = group[:plan.window]
    t_len = len(group)
    closed = api.planner.window_bytes(
        spec, cfg.truncate_rank, cfg.oversample, exact=plan.rank is None,
        window=t_len, batch_rank=plan.rank, nnz_slots=slots)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    (_, _), win_sync = sync_sites(lambda: sw.ingest_window(st, group, cfg,
                                                           plan))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    check(peak <= closed, f"{name}: one window of {t_len} batches peaked at "
          f"{peak:,}B above R6's closed form {closed:,}B")

    def one_by_one():
        s = st
        for x in group:
            s, _ = sw.ingest_window(s, [x], cfg, plan)
        return s
    _, loop_sync = sync_sites(one_by_one)
    with spans() as rec:          # where a window's time goes
        sw.ingest_window(st, group, cfg, plan)
    window_stages = sum_stages(rec)
    with spans() as rec:
        api.svd_update(st, batches[1], cfg)
    update_stages = sum_stages(rec)
    _, upd_sync = sync_sites(
        lambda: api.svd_update(st, batches[1], cfg).state)
    return dict(
        batches=len(batches), growth_batches=1,
        window=auto.plan.window, r6_reason=auto.plan.reasons[-1],
        dispatch_auto=counts_auto, dispatch_loop=counts_loop,
        bucket=list(sig), plan_peak_bytes=auto.plan.peak_bytes,
        ms_per_batch={mode: [secs / len(batches) * 1e3, again[mode]
                             / len(batches) * 1e3]
                      for mode, secs in (("window", auto_s), ("loop", loop_s),
                                         ("svd_update", upd_s))},
        max_abs_dS_vs_svd_update=ds, dS_limit=1e-3 * float(upd.s[0]),
        u_ortho_err=u_err, v_ortho_err=v_err,
        lonely_rows=auto.state.lonely_rows_seen,
        repaired_rows=auto.state.repaired_rows_seen,
        window_stage_ms=window_stages, svd_update_stage_ms=update_stages,
        measured_window=dict(batches=t_len, peak_bytes=peak,
                             r6_window_bytes=closed,
                             peak_over_closed_form=peak / closed),
        host_syncs=dict(
            window=dict(total=sum(win_sync.values()), batches=t_len,
                        sites=win_sync),
            loop=dict(total=sum(loop_sync.values()), batches=t_len,
                      sites=loop_sync),
            svd_update=dict(total=sum(upd_sync.values()), batches=1,
                            sites=upd_sync)),
        clocks="ms_per_batch: host clock around the whole stream (its host "
               "prologue included), the device synchronized at both ends; "
               "[in the order window, loop, svd_update; then in the "
               "opposite order]")


def padded_kernel_times(st, delta, cases) -> dict:
    """The kernels on one catalogue batch as its bucket pads it (rows to
    m_pad, stored columns to C_pad, slots to K_pad, all padding zero) and
    as it is: sparse_gram's padded gram is the unpadded one bit for bit
    (padded rows and columns zero), sketch_panel's padded panel the
    unpadded one in its first C columns and zero beyond; times side by
    side with the slot counts."""
    from repro_torch.stream import window as sw

    e = stream_state.as_delta(delta, st, device="cpu")
    sig = sw.bucket_signature(e)
    _, m_pad, c_pad, k_pad = sig
    ids, rows, vals = (x[0] for x in sw.build_window([e], sig,
                                                     device=DEVICE))
    e = e.to(DEVICE)
    m, (c, k) = e.m, e.capacity
    g_pad = sg_mod.sparse_gram(rows, vals, m_pad)
    g = sg_mod.sparse_gram(e.col_rows, e.col_vals, m)
    check(torch.equal(g_pad[:, :m, :m], g)
          and float(g_pad[:, m:].abs().sum()) == 0.0
          and float(g_pad[:, :, m:].abs().sum()) == 0.0,
          "sparse_gram: the bucket's padding changed the gram")
    gen = torch.Generator(DEVICE).manual_seed(8)
    omega = torch.randn((72, m_pad), device=DEVICE, generator=gen)
    p_pad = sp_mod.sketch_panel(omega, rows, vals)
    p = sp_mod.sketch_panel(omega[:, :m].contiguous(), e.col_rows,
                            e.col_vals)
    check(torch.equal(p_pad[:, :, :c], p)
          and float(p_pad[:, :, c:].abs().sum()) == 0.0,
          "sketch_panel: the bucket's padding changed the panel")
    cases.append(dict(kernel="sparse_gram", case="catalogue batch, padded "
                      "bucket vs unpadded", max_abs_err=0.0, limit=0.0))
    cases.append(dict(kernel="sketch_panel", case="catalogue batch, padded "
                      "bucket vs unpadded", max_abs_err=0.0, limit=0.0))
    slots = dict(padded=int(rows.numel()), unpadded=int(e.col_rows.numel()),
                 nonzero=int((e.col_vals != 0).sum()))
    out = dict(bucket=list(sig), unpadded_capacity=[m, c, k], slots=slots,
               padded_over_unpadded_slots=slots["padded"]
               / slots["unpadded"])
    for kname, fp, fu in (
            ("sparse_gram", lambda: sg_mod.sparse_gram(rows, vals, m_pad),
             lambda: sg_mod.sparse_gram(e.col_rows, e.col_vals, m)),
            ("sketch_panel", lambda: sp_mod.sketch_panel(omega, rows, vals),
             lambda: sp_mod.sketch_panel(omega[:, :m].contiguous(),
                                         e.col_rows, e.col_vals))):
        tp, tu = time_ms(fp), time_ms(fu)
        out[kname] = dict(padded_ms=tp, unpadded_ms=tu,
                          padded_over_unpadded=tp / tu,
                          padded_device_ms=device_ms(fp),
                          unpadded_device_ms=device_ms(fu))
    return out


def phase_stream_window(state) -> None:
    """svd_stream on the card: (a) the catalogue continued from
    ``serve_scaled`` at rank 64 in ELL batches (``sparse_gram`` a step),
    (b) the paper's rows in dense batches at rank 16 (``blockgram`` a
    step); each window=auto against window=1 (the same bits) and against a
    plain svd_update loop."""
    sc = STREAM_WINDOW
    rng = np.random.default_rng(77)
    t0 = time.perf_counter()
    sizes = [1024] + [int(x) for x in rng.integers(sc["rows"][0],
                                                   sc["rows"][1] + 1,
                                                   sc["batches"])]
    cat = [sparse.random_bipartite(r, sc["n"], sc["density"], seed=500 + b,
                                   power_law=True)
           for b, r in enumerate(sizes)]
    t_gen = time.perf_counter() - t0
    cfg = api.SolveConfig(method="neighbor_random", truncate_rank=sc["rank"],
                          num_blocks=NUM_BLOCKS, use_kernel=True,
                          memory_budget_bytes=sc["budget"])
    cases = state["kernel_cases"]
    out = dict(catalogue=stream_case(state, "catalogue", cat, cfg,
                                     "sparse_gram"))
    st = api.svd_init(sc["n"], cfg, device=DEVICE)
    st = api.svd_update(st, cat[0], cfg).state
    out["catalogue"]["padding"] = padded_kernel_times(st, cat[1], cases)
    out["catalogue"]["host_generate_s"] = t_gen
    del cat, st
    torch.cuda.empty_cache()

    coo = state["coo"]
    m = coo.shape[0]
    bounds, lo = [0], 0
    while lo < m:
        lo = min(m, lo + (64 if lo == 0 else int(rng.integers(
            PAPER_WINDOW["rows"][0], PAPER_WINDOW["rows"][1] + 1))))
        bounds.append(lo)
    paper = [coo_rows(coo, a, b).todense() for a, b in zip(bounds, bounds[1:])]
    cfg = api.SolveConfig(method="neighbor_random",
                          truncate_rank=PAPER_WINDOW["rank"],
                          num_blocks=NUM_BLOCKS, use_kernel=True)
    out["paper_dense"] = stream_case(state, "paper dense", paper, cfg,
                                     "blockgram")
    out["paper_dense"]["batch_rows"] = list(np.diff(bounds).tolist())
    emit("stream_window", **out)
    torch.cuda.empty_cache()


MERGE_AB_SEEDS = (2020, 2021, 2022)


def run_stream(coo, cfg, bounds):
    """svd_init + one svd_update per row range; (state, merge.svd ms per
    batch)."""
    st = api.svd_init(coo.shape[1], cfg, device=DEVICE)
    merge_ms = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        with spans() as rec:
            st = api.svd_update(st, coo_rows(coo, int(lo), int(hi)),
                                cfg).state
        merge_ms.append(rec.times["merge.svd"][0])
    return st, merge_ms


def phase_merge_driver_ab(state) -> None:
    """The merge SVD's cuSOLVER driver, torch's default (``gesvdj``)
    against ``gesvd``, in one run: for paper-shaped matrices from three
    seeds, the exact stream (4 batches, full rank) and the user stream
    (batches of 64, rank 16) under each driver, the order of the drivers
    alternating from seed to seed.  Records ||U^T U - I||, ||V^T V - I||,
    the exact stream's max|dS| against float64, and merge.svd per batch.
    The committed driver (``hierarchy.CUDA_SVD_DRIVER``) is held to 1e-4;
    the other is only recorded."""
    committed = hierarchy.CUDA_SVD_DRIVER
    drivers = (None, "gesvd")
    warm = torch.randn((170_904, 40), device=DEVICE)
    for drv in drivers:                # cuSOLVER handles and workspaces
        torch.linalg.svd(warm, full_matrices=False, driver=drv)
    del warm
    runs = []
    try:
        for i, seed in enumerate(MERGE_AB_SEEDS):
            coo = bipartite.paper_coo(RankyPaperConfig(seed=seed))
            m, n = coo.shape
            ell = sparse.block_ell_from_coo(coo, NUM_BLOCKS, device=DEVICE)
            s_ref = reference_svals(ranky.split_and_repair(
                ell, NUM_BLOCKS, "none"), NUM_BLOCKS)
            del ell
            exact_cfg = api.SolveConfig(method="none", truncate_rank=m,
                                        num_blocks=NUM_BLOCKS,
                                        use_kernel=True)
            user_cfg = api.SolveConfig(method="neighbor_random",
                                       truncate_rank=16, oversample=8,
                                       num_blocks=NUM_BLOCKS,
                                       use_kernel=True)
            exact_bounds = np.linspace(0, m, 5).astype(int)
            user_bounds = list(range(0, m, STREAM_BATCH_ROWS)) + [m]
            for drv in (drivers if i % 2 == 0 else drivers[::-1]):
                hierarchy.CUDA_SVD_DRIVER = drv
                st, ex_ms = run_stream(coo, exact_cfg, exact_bounds)
                ex = dict(u_ortho_err=ortho_err(st.u),
                          v_ortho_err=ortho_err(st.v),
                          max_abs_dS=float((st.s.double() - s_ref)
                                           .abs().max()),
                          merge_svd_ms=ex_ms)
                st, us_ms = run_stream(coo, user_cfg, user_bounds)
                us = dict(u_ortho_err=ortho_err(st.u),
                          v_ortho_err=ortho_err(st.v), merge_svd_ms=us_ms)
                runs.append(dict(seed=seed, driver=drv or "default",
                                 exact=ex, user=us))
    finally:
        hierarchy.CUDA_SVD_DRIVER = committed
    summary = {}
    for drv in drivers:
        mine = [r for r in runs if r["driver"] == (drv or "default")]
        summary[drv or "default"] = {
            f"{kind}_{what}": max(r[kind][f"{what}_ortho_err"] for r in mine)
            for kind in ("exact", "user") for what in ("u", "v")}
        summary[drv or "default"].update(
            exact_merge_svd_ms_total=sum(sum(r["exact"]["merge_svd_ms"])
                                         for r in mine),
            user_merge_svd_ms_total=sum(sum(r["user"]["merge_svd_ms"])
                                        for r in mine))
    worst = max(v for k, v in summary[committed or "default"].items()
                if k.endswith(("_u", "_v")))
    check(worst <= 1e-4, f"merge_driver_ab: the committed driver "
          f"{committed or 'default'} reaches |X^T X - I| {worst} > 1e-4")
    emit("merge_driver_ab", committed=committed or "default",
         seeds=list(MERGE_AB_SEEDS), worst_ortho_err_and_ms=summary,
         runs=runs, ortho_limit=1e-4)


# ---------------------------------------------------------------------------
# Phase 12: LM serving of zamba2-2.7b at full width
# ---------------------------------------------------------------------------

def synced_ms(fn):
    """(result, host ms) of ``fn()`` between two device synchronizations."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def profile_prefill(cfg, params, batch) -> dict:
    """Device time by kernel over one warm prefill (``torch.profiler``):
    the kernels' own records only (the operators that launch them carry
    the same time again and are left out), the ten largest, the port's
    two kernels wherever they rank (``port_kernels``), and their sum,
    beside the wall of that same profiled prefill (host clock between two
    synchronizations) and the busy share, their ratio; ``kernel_ms_total``
    is None where the profiler saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall_ms = synced_ms(
            lambda: transformer.prefill_forward(cfg, params, batch))
    rows, other = [], {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        dev = getattr(ev, "self_device_time_total",
                      getattr(ev, "self_cuda_time_total", 0.0)) / 1e3
        if ev.key.startswith("Command Buffer"):   # a CUPTI record, no kernel
            other[ev.key] = dict(device_ms=dev, count=ev.count)
        elif dev > 0:
            rows.append((dev, ev.key, ev.count))
    rows.sort(reverse=True)
    total = sum(r[0] for r in rows) if rows else None
    return dict(kernel_ms_total=total, profiled_wall_ms=wall_ms,
                busy_share_of_profiled_wall=(total / wall_ms if rows
                                             else None),
                kernels=len(rows), other_records=other,
                top=[dict(name=k[:80], device_ms=ms, calls=n)
                     for ms, k, n in rows[:10]],
                port_kernels=[dict(name=k[:80], device_ms=ms, calls=n)
                              for ms, k, n in rows
                              if "attn_kernel" in k or "ssd_kernel" in k])


def against_steps(label, lg, c, lg_d, c_d, rel) -> dict:
    """Each of last logits and every cache entry against the token-by-token
    prefill's: max abs error beside ``rel`` * max|.|."""
    out = {}
    for key in ["logits"] + [k for k in c_d if k != "len"]:
        got, want = (lg, lg_d) if key == "logits" else (c[key], c_d[key])
        check(got.shape == want.shape and got.dtype == want.dtype,
              f"{label}: {key} shape/dtype")
        err = max_err(got, want)
        top = float(want.abs().max())
        out[key] = dict(max_abs_err=err, limit=rel * top, max_abs=top,
                        err_over_max=err / top)
    return out


@contextlib.contextmanager
def bf16_rounded_kernels():
    """Within: both LM kernels fed their inputs rounded through bf16, as a
    kernel that computed in bf16 would be (the float32 checks' control)."""
    def rounded(fn):
        def wrap(*args, **kw):
            return fn(*(t.bfloat16().float() for t in args), **kw)
        return wrap

    saved = kernel_ops.flash_attention, kernel_ops.ssd_scan
    kernel_ops.flash_attention, kernel_ops.ssd_scan = map(rounded, saved)
    try:
        yield
    finally:
        kernel_ops.flash_attention, kernel_ops.ssd_scan = saved


def lm_requests(cfg, n: int, seed: int = 0):
    """Requests of 2-11 tokens, as ``launch/serve.py`` makes them."""
    rng = np.random.default_rng(seed)
    return [list(rng.integers(1, cfg.vocab_size, size=rng.integers(2, 12)))
            for _ in range(n)]


def phase_lm_serve(state) -> None:
    torch.cuda.empty_cache()
    cfg = get_config(LM_ARCH)
    pf, ck, rq = LM_PREFILL, LM_CHECK, LM_REQUESTS
    gen = torch.Generator(DEVICE).manual_seed(0)
    params, init_ms = synced_ms(lambda: schema.init_params(cfg, gen, DEVICE))
    n_params = schema.param_count_actual(params)
    check(n_params >= cfg.param_count(),
          f"lm_serve: {n_params} parameters < the config's {cfg.param_count()}")
    tokens = torch.randint(0, cfg.vocab_size, (pf["batch"], pf["seq"]),
                           generator=gen, device=DEVICE)
    batch = {"tokens": tokens}
    max_seq = pf["seq"] + pf["decode"]

    # (a) the main path: prefill through both kernels, then greedy decode
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    (logits, cache), prefill_ms = synced_ms(
        lambda: transformer.prefill_forward(cfg, params, batch,
                                            max_seq=max_seq))
    counts = read_counts()
    keep_counts(state, "lm_serve[prefill]", counts)
    groups = cfg.num_layers // cfg.hybrid_attn_every
    check(counts["flash_attention"] == groups and
          counts["ssd_scan"] == cfg.num_layers,
          f"lm_serve: a prefill launched flash_attention "
          f"{counts['flash_attention']} times (want {groups}) and ssd_scan "
          f"{counts['ssd_scan']} times (want {cfg.num_layers})")
    check(logits.shape == (pf["batch"], cfg.padded_vocab)
          and logits.dtype == torch.float32
          and bool(torch.isfinite(logits).all()),
          "lm_serve: prefill logits not finite (B, Vp) float32")
    check(cache["len"] == pf["seq"] and cache["k"].dtype == torch.bfloat16,
          "lm_serve: prefill cache")
    reset_counts()
    out_tokens = []

    def decode_all():
        nonlocal logits, cache
        for _ in range(pf["decode"]):
            tok = engine.sample(cfg, logits, 0.0, gen)
            out_tokens.append(tok)
            logits, cache = transformer.decode_step(
                cfg, params, cache, {"tokens": tok[:, None]})

    _, decode_ms = synced_ms(decode_all)
    decode_counts = read_counts()
    peak_bytes = torch.cuda.max_memory_allocated()
    toks = torch.stack(out_tokens, dim=1)
    check(bool(torch.isfinite(logits).all()), "lm_serve: decode logits")
    check(int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size,
          "lm_serve: decoded tokens outside the vocab")
    check(cache["len"] == max_seq, "lm_serve: cache length after decode")
    _, warm_prefill_ms = synced_ms(
        lambda: transformer.prefill_forward(cfg, params, batch,
                                            max_seq=max_seq))
    del cache, logits
    prof = profile_prefill(cfg, params, batch)

    # a long prefill: s * s = 3000**2 is past the 2048**2 at which the
    # reference leaves its kernel; the port's kernels take every length
    long_tokens = torch.randint(0, cfg.vocab_size,
                                (LM_LONG["batch"], LM_LONG["seq"]),
                                generator=gen, device=DEVICE)
    reset_counts()
    (long_logits, long_cache), long_ms = synced_ms(
        lambda: transformer.prefill_forward(cfg, params,
                                            {"tokens": long_tokens}))
    lcounts = read_counts()
    keep_counts(state, "lm_serve[long prefill]", lcounts)
    check(lcounts["flash_attention"] == groups
          and lcounts["ssd_scan"] == cfg.num_layers,
          f"lm_serve: the long prefill launched flash_attention "
          f"{lcounts['flash_attention']} times (want {groups}) and ssd_scan "
          f"{lcounts['ssd_scan']} times (want {cfg.num_layers})")
    check(long_logits.shape == (LM_LONG["batch"], cfg.padded_vocab)
          and bool(torch.isfinite(long_logits).all())
          and long_cache["len"] == LM_LONG["seq"],
          "lm_serve: long prefill logits not finite or cache length wrong")
    del long_logits, long_cache
    main_fields = dict(
        prompts=pf["batch"], prompt_tokens=pf["seq"],
        decode_steps=pf["decode"], dtype=cfg.dtype,
        init_params_ms=init_ms, params=n_params,
        launches_per_prefill=dict(flash_attention=counts["flash_attention"],
                                  ssd_scan=counts["ssd_scan"]),
        launches_in_decode=decode_counts,
        prefill_ms_first=prefill_ms, prefill_ms_warm=warm_prefill_ms,
        prefill_tokens_per_s=pf["batch"] * pf["seq"] / warm_prefill_ms * 1e3,
        decode_ms_per_step=decode_ms / pf["decode"],
        decode_tokens_per_s=pf["batch"] * pf["decode"] / decode_ms * 1e3,
        peak_memory_bytes=peak_bytes, prefill_profile=prof,
        long_prefill=dict(prompts=LM_LONG["batch"],
                          prompt_tokens=LM_LONG["seq"], ms=long_ms,
                          tokens_per_s=LM_LONG["batch"] * LM_LONG["seq"]
                          / long_ms * 1e3,
                          launches=dict(
                              flash_attention=lcounts["flash_attention"],
                              ssd_scan=lcounts["ssd_scan"])))

    # (b) the kernels inside the model, float32: whole-prompt prefill
    # (both kernels) against the engine's token-by-token prefill (none)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    toks32 = torch.randint(0, cfg.vocab_size, (ck["batch"], ck["seq"]),
                           generator=gen, device=DEVICE)
    reset_counts()
    (lg_k, c_k), check_prefill_ms = synced_ms(
        lambda: transformer.prefill_forward(cfg32, params,
                                            {"tokens": toks32}))
    kcounts = read_counts()
    check(kcounts["flash_attention"] == groups
          and kcounts["ssd_scan"] == cfg.num_layers,
          f"lm_serve[check]: the float32 prefill launched {kcounts}")
    reset_counts()
    (c_d, lg_d), steps_ms = synced_ms(
        lambda: engine.prefill_cache(cfg32, params, toks32,
                                     engine.ServeConfig(max_seq=ck["seq"])))
    dcounts = read_counts()
    check(dcounts["flash_attention"] == 0 and dcounts["ssd_scan"] == 0,
          f"lm_serve[check]: decode steps launched {dcounts}")
    errs = against_steps("lm_serve[check]", lg_k, c_k, lg_d, c_d, ck["rel"])
    for key, e in errs.items():
        check(e["max_abs_err"] <= e["limit"],
              f"lm_serve[check]: {key} max abs err {e['max_abs_err']} > "
              f"{e['limit']} (prefill_forward vs prefill_cache, float32)")
    del c_k, lg_k

    # The control: the same float32 prefill with both kernels fed inputs
    # rounded through bf16, as a kernel that computed in bf16 would be.
    # It must exceed the limit, or the limit could not tell such a kernel.
    with bf16_rounded_kernels():
        lg_r, c_r = transformer.prefill_forward(cfg32, params,
                                                {"tokens": toks32})
    control = against_steps("lm_serve[check]", lg_r, c_r, lg_d, c_d,
                            ck["rel"])
    check(any(e["max_abs_err"] > e["limit"] for e in control.values()),
          f"lm_serve[check]: the bf16-rounded control stays within the "
          f"limit {ck['rel']} of max, which therefore cannot tell it: "
          f"{control}")
    del c_d, lg_d, c_r, lg_r

    # (c) the engine: short requests, greedy and sampled
    reqs = lm_requests(cfg, rq["requests"])
    prompts_np, lens = engine.batch_requests(reqs)
    prompts = torch.from_numpy(prompts_np).to(DEVICE)
    scfg = engine.ServeConfig(max_seq=prompts.shape[1] + rq["tokens"])
    greedy, greedy_ms = synced_ms(
        lambda: engine.generate(cfg, params, prompts, scfg, rq["tokens"]))
    greedy2 = engine.generate(cfg, params, prompts, scfg, rq["tokens"])
    check(torch.equal(greedy, greedy2), "lm_serve: greedy generation is not "
          "deterministic")
    hot = engine.ServeConfig(max_seq=scfg.max_seq,
                             temperature=rq["temperature"])
    sampled = [engine.generate(cfg, params, prompts, hot, rq["tokens"],
                               generator=torch.Generator(DEVICE)
                               .manual_seed(7)) for _ in range(2)]
    check(torch.equal(sampled[0], sampled[1]),
          "lm_serve: sampling from one seed is not repeatable")
    for out in (greedy, sampled[0]):
        check(out.shape == (rq["requests"], rq["tokens"])
              and out.dtype == torch.int32 and int(out.min()) >= 0
              and int(out.max()) < cfg.vocab_size,
              "lm_serve: generated tokens")
    del params
    torch.cuda.empty_cache()
    emit("lm_serve", arch=LM_ARCH, layers=cfg.num_layers,
         d_model=cfg.d_model, main=main_fields,
         check=dict(batch=ck["batch"], prompt_tokens=ck["seq"],
                    dtype="float32", rel_limit=ck["rel"],
                    prefill_forward_ms=check_prefill_ms,
                    prefill_cache_ms=steps_ms, errors=errs,
                    bf16_rounded_control=control),
         generate=dict(requests=rq["requests"], prompt_lens=lens.tolist(),
                       tokens=rq["tokens"], greedy_ms=greedy_ms,
                       greedy_tokens_per_s=rq["requests"] * rq["tokens"]
                       / greedy_ms * 1e3,
                       sampled_differs_from_greedy=not torch.equal(
                           greedy, sampled[0])),
         clocks="host clock between device synchronizations; "
                "prefill_ms_first includes first-call cuBLAS set-up")


# ---------------------------------------------------------------------------
# Phase 12b: the ssm, dense and vlm families at full width
# ---------------------------------------------------------------------------

def vlm_positions(b: int, s: int, patch: int, start: int) -> torch.Tensor:
    """(B, S, 3) M-RoPE ids of a prompt with one image: text at 0..start-1,
    a ``patch`` x ``patch`` block of patch tokens from ``start`` on
    (temporal ``start``, height ``start`` + row, width ``start`` + column),
    then text from ``start + patch`` on, the three streams equal."""
    i = torch.arange(s, device=DEVICE)
    j = i - start
    block = (j >= 0) & (j < patch * patch)
    text = torch.where(j >= patch * patch, start + patch + j - patch * patch,
                       i)
    t = torch.where(block, start, text)
    h = torch.where(block, start + torch.div(j, patch, rounding_mode="floor"),
                    text)
    w = torch.where(block, start + j % patch, text)
    return torch.stack([t, h, w], dim=-1)[None].expand(b, s, 3).contiguous()


def text_positions(b: int, s: int) -> torch.Tensor:
    """(B, S, 3) M-RoPE ids of text: the three streams equal, 0..S-1."""
    return torch.arange(s, device=DEVICE)[None, :, None].expand(
        b, s, 3).contiguous()


def family_batch(cfg, tokens, pos=None, frames=None) -> dict:
    batch = {"tokens": tokens}
    if cfg.use_mrope:
        batch["pos"] = (pos if pos is not None
                        else text_positions(*tokens.shape))
    if cfg.is_encdec:
        batch["frames"] = frames
    return batch


def launches_of(cfg, attn: int, scan: int = 0) -> dict:
    """Every kernel's count 0 but ``flash_attention`` and ``ssd_scan``."""
    want = {k: 0 for k in read_counts()}
    want.update(flash_attention=attn, ssd_scan=scan)
    return want


def want_launches(cfg, label, counts) -> None:
    """A prefill launches ``flash_attention`` once an attention layer
    (encdec: each encoder layer, each decoder layer's self- and
    cross-attention) and ``ssd_scan`` once a Mamba-2 layer, exactly, and
    nothing else."""
    attn = {"dense": cfg.num_layers, "vlm": cfg.num_layers,
            "moe": cfg.num_layers,
            "encdec": cfg.encoder_layers + 2 * cfg.num_layers}
    want = launches_of(cfg, attn.get(cfg.family, 0),
                       cfg.num_layers if cfg.family == "ssm" else 0)
    check(counts == want, f"lm_families[{label}]: launched {counts}, want "
          f"{want}")


def family_serve(state, cfg, params, gen, *, batch, seq, decode,
                 max_seq=None, pos=None, frames=None) -> dict:
    """The served path in the config's bf16: ``prefill_forward`` of
    ``batch`` prompts of ``seq`` tokens (first call, then warm), then
    ``decode`` greedy ``decode_step``s; times, tokens/s, peak, launches."""
    label = cfg.name
    max_seq = max_seq or seq + decode
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                           device=DEVICE)
    inputs = family_batch(cfg, tokens, pos, frames)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    (logits, cache), first_ms = synced_ms(
        lambda: transformer.prefill_forward(cfg, params, inputs,
                                            max_seq=max_seq))
    counts = read_counts()
    keep_counts(state, f"lm_families[{label} prefill]", counts)
    want_launches(cfg, f"{label} prefill", counts)
    check(logits.shape == (batch, cfg.padded_vocab)
          and logits.dtype == torch.float32
          and bool(torch.isfinite(logits).all()) and cache["len"] == seq,
          f"lm_families[{label}]: prefill logits or cache")
    prefill_peak = torch.cuda.max_memory_allocated()
    reset_counts()
    out_tokens = []

    def decode_all():
        nonlocal logits, cache
        for _ in range(decode):
            tok = engine.sample(cfg, logits, 0.0, gen)
            out_tokens.append(tok)
            logits, cache = engine.step(cfg, params, cache, tok[:, None])

    _, decode_ms = synced_ms(decode_all)
    dcounts = read_counts()
    keep_counts(state, f"lm_families[{label} decode]", dcounts)
    toks = torch.stack(out_tokens, dim=1)
    check(bool(torch.isfinite(logits).all())
          and int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size
          and cache["len"] == seq + decode,
          f"lm_families[{label}]: decode logits, tokens or cache length")
    peak = torch.cuda.max_memory_allocated()
    del cache, logits
    _, warm_ms = synced_ms(
        lambda: transformer.prefill_forward(cfg, params, inputs,
                                            max_seq=max_seq))
    state.setdefault("measured", {})[f"{label} prefill"] = dict(
        ms=warm_ms, batch=batch, seq=seq, max_seq=max_seq)
    return dict(prompts=batch, prompt_tokens=seq, max_seq=max_seq,
                decode_steps=decode, dtype=cfg.dtype,
                launches_per_prefill=dict(
                    flash_attention=counts["flash_attention"],
                    ssd_scan=counts["ssd_scan"]),
                launches_in_decode=dict(
                    flash_attention=dcounts["flash_attention"],
                    ssd_scan=dcounts["ssd_scan"]),
                prefill_ms_first=first_ms, prefill_ms_warm=warm_ms,
                prefill_tokens_per_s=batch * seq / warm_ms * 1e3,
                decode_ms_per_step=decode_ms / decode,
                decode_tokens_per_s=batch * decode / decode_ms * 1e3,
                prefill_peak_bytes=prefill_peak, peak_bytes=peak)


def family_check(state, cfg32, params, tokens, control, control_is,
                 frames=None) -> dict:
    """The kernels inside the model, float32: ``prefill_forward`` (the
    kernels) against ``engine.prefill_cache`` (decode steps, none; encdec:
    its encoder over ``frames`` through the kernel, then decode steps) of
    the same prompt, within LM_CHECK's limit; then ``control()``, a
    prefill (``control_is``) that must exceed it."""
    label = f"{cfg32.name} check"
    rel = LM_CHECK["rel"]
    reset_counts()
    (lg_k, c_k), fwd_ms = synced_ms(lambda: transformer.prefill_forward(
        cfg32, params, family_batch(cfg32, tokens, frames=frames)))
    counts = read_counts()
    keep_counts(state, f"lm_families[{label}]", counts)
    want_launches(cfg32, label, counts)
    reset_counts()
    (c_d, lg_d), steps_ms = synced_ms(lambda: engine.prefill_cache(
        cfg32, params, tokens, engine.ServeConfig(max_seq=tokens.shape[1]),
        frames=frames))
    dcounts = read_counts()
    check(dcounts == launches_of(cfg32, cfg32.encoder_layers),
          f"lm_families[{label}]: the engine's prefill launched {dcounts}")
    errs = against_steps(f"lm_families[{label}]", lg_k, c_k, lg_d, c_d, rel)
    for key, e in errs.items():
        check(e["max_abs_err"] <= e["limit"],
              f"lm_families[{label}]: {key} max abs err {e['max_abs_err']} "
              f"> {e['limit']} (prefill_forward vs prefill_cache, float32)")
    del lg_k, c_k
    lg_r, c_r = control()
    ctrl = against_steps(f"lm_families[{label}]", lg_r, c_r, lg_d, c_d, rel)
    check(any(e["max_abs_err"] > e["limit"] for e in ctrl.values()),
          f"lm_families[{label}]: the control stays within the limit {rel} "
          f"of max, which therefore cannot tell it: {ctrl}")
    return dict(batch=tokens.shape[0], prompt_tokens=tokens.shape[1],
                dtype="float32", rel_limit=rel, prefill_forward_ms=fwd_ms,
                prefill_cache_ms=steps_ms, errors=errs, control=ctrl,
                control_is=control_is)


def rounded_check(state, cfg32, params, tokens, frames=None) -> dict:
    """``family_check`` whose control is the same float32 prefill with
    both kernels fed bf16-rounded inputs."""
    def control():
        with bf16_rounded_kernels():
            return transformer.prefill_forward(
                cfg32, params, family_batch(cfg32, tokens, frames=frames))
    return family_check(state, cfg32, params, tokens, control,
                        "kernels fed bf16-rounded inputs", frames)


def int8_decode(cfg, params, toks, *, quant: bool, dtype):
    """Teacher-forced decode steps of ``toks`` (B, T) from an empty cache
    (int8 with ``quant``, else ``dtype``): (logits (B, T, V) over the real
    vocab, ms a step, the cache's bytes)."""
    b, steps = toks.shape
    cache = transformer.init_cache(cfg, b, steps, dtype=dtype, device=DEVICE,
                                   kv_quant=quant)
    check(cache["k"].dtype == (torch.int8 if quant else dtype),
          "lm_families: int8 cache dtype")
    nbytes = sum(t.numel() * t.element_size()
                 for k, t in cache.items() if k != "len")
    outs = []

    def run():
        for t in range(steps):
            outs.append(transformer.decode_step(
                cfg, params, cache, {"tokens": toks[:, t:t + 1]})[0])

    _, ms = synced_ms(run)
    return torch.stack(outs, 1)[..., :cfg.vocab_size], ms / steps, nbytes


@contextlib.contextmanager
def routing_log(log: list, mode: str):
    """Within, each moe layer call's routing held against ``log``, one
    entry a call in call order: "record" appends the call's expert choice
    (T, K); "compare" routes as the model does and counts the tokens whose
    set of experts differs from the recorded one; "pin" counts the same,
    then routes as recorded (the gates: the router's probabilities of the
    recorded experts, renormalised).  Yields the counts, device tensors."""
    flips, route, recorded = [], moe_mod._route, iter(log)

    def routed(cfg, router_w, x_flat):
        gates, idx, aux = route(cfg, router_w, x_flat)
        if mode == "record":
            log.append(idx)
            return gates, idx, aux
        want = next(recorded)
        flips.append((idx.sort(-1).values != want.sort(-1).values)
                     .any(-1).sum())
        if mode == "pin":
            probs = torch.softmax(x_flat.float() @ router_w.float(), dim=-1)
            gates = probs.gather(1, want)
            gates, idx = gates / gates.sum(-1, keepdim=True), want
        return gates, idx, aux

    moe_mod._route = routed
    try:
        yield flips
    finally:
        moe_mod._route = route


def int8_gap(q8, full) -> dict:
    """int8-cache logits against the float cache's, by KV_INT8's limits."""
    lim = KV_INT8
    diff = (q8 - full).abs()
    excess = float((diff - lim["atol"] - lim["rtol"] * full.abs()).max())
    return dict(max_abs_diff=float(diff.max()), max_excess_over_limit=excess,
                within_limits=excess <= 0,
                greedy_agreement=float((q8.argmax(-1) == full.argmax(-1))
                                       .float().mean()))


def int8_against_float(cfg, params, gen, batch: int, steps: int) -> dict:
    """The int8 KV cache against a float cache, ``steps`` teacher-forced
    steps of ``batch`` rows from an empty cache.  Held at the reference's
    ``tests/test_kvquant.py`` limits in its own setting, float32 compute
    against a float32 cache; then in the config's bf16 against the bf16
    cache, where the greedy agreement is held and the excess over the same
    limits recorded (bf16 activations move the logits further: PERF.md
    §6); the caches' bytes.  A moe model's int8 run is held with its
    routing pinned to the float run's, so that the gap is the cache's
    (top-K routing is discontinuous: a hidden state moved by the int8
    cache can flip a token's experts, in the reference as here); its free
    run is recorded beside, with the count of flipped routings."""
    lim, moe = KV_INT8, cfg.family == "moe"
    toks = torch.randint(0, cfg.vocab_size, (batch, steps), generator=gen,
                         device=DEVICE)
    out = dict(batch=batch, steps=steps, **lim)
    for tag, c, dtype in (
            ("float32", dataclasses.replace(cfg, dtype="float32"),
             torch.float32),
            ("bfloat16", cfg, torch.bfloat16)):
        log = []
        with (routing_log(log, "record") if moe
              else contextlib.nullcontext()):
            full, ms_full, b_full = int8_decode(c, params, toks, quant=False,
                                                dtype=dtype)
        with (routing_log(log, "pin") if moe
              else contextlib.nullcontext()) as pinned_flips:
            q8, ms_q8, b_q8 = int8_decode(c, params, toks, quant=True,
                                          dtype=dtype)
        gap = int8_gap(q8, full)
        held = "the routing pinned to the float run's" if moe else "free"
        check(gap["greedy_agreement"] >= lim["agree"],
              f"lm_families[{cfg.name} int8 {tag}, {held}]: greedy "
              f"agreement {gap['greedy_agreement']} < {lim['agree']}")
        if tag == "float32":
            check(gap["within_limits"],
                  f"lm_families[{cfg.name} int8 float32, {held}]: logits "
                  f"exceed rtol {lim['rtol']}, atol {lim['atol']} of the "
                  f"float32 cache's by {gap['max_excess_over_limit']}")
        out[tag] = dict(gap, held=held, ms_per_step_float_cache=ms_full,
                        ms_per_step_int8=ms_q8, cache_bytes_float=b_full,
                        cache_bytes_int8=b_q8, cache_bytes_ratio=b_q8 / b_full)
        if moe:
            with routing_log(log, "compare") as flips:
                free = int8_decode(c, params, toks, quant=True,
                                   dtype=dtype)[0]
            out[tag]["free_routing"] = dict(
                int8_gap(free, full), routings=sum(x.shape[0] for x in log),
                flipped=int(sum(flips)),
                flipped_under_the_pin=int(sum(pinned_flips)))
    return out


def family_params(cfg, seed: int):
    """Random float32 master weights from a seeded generator on the card."""
    gen = torch.Generator(DEVICE).manual_seed(seed)
    params, ms = synced_ms(lambda: schema.init_params(cfg, gen, DEVICE))
    n = schema.param_count_actual(params)
    check(n >= cfg.param_count(), f"lm_families[{cfg.name}]: {n} parameters "
          f"< the config's {cfg.param_count()}")
    return params, gen, dict(params=n, init_params_ms=ms)


def first_layers(params, n: int) -> dict:
    """The model cut to its first ``n`` layers (views, no copy)."""
    return dict(params, layers={k: v[:n] for k, v in params["layers"].items()})


def free_model() -> None:
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def phase_lm_families(state) -> None:
    t_phase = time.perf_counter()
    free_model()

    # (a) gemma2-9b at full width and depth, then (b) its first 4 layers
    # in float32, the window inside the model.
    t0 = time.perf_counter()
    g = GEMMA
    cfg = get_config(g["arch"])
    params, gen, init = family_params(cfg, 23)
    serve = family_serve(state, cfg, params, gen, batch=g["batch"],
                         seq=g["seq"], decode=g["decode"],
                         max_seq=g["max_seq"])
    int8 = int8_against_float(cfg, params, gen, g["int8_batch"],
                              g["int8_steps"])
    gc = GEMMA_CHECK
    cfg32 = dataclasses.replace(cfg, num_layers=gc["layers"], dtype="float32")
    p4 = first_layers(params, gc["layers"])
    toks = torch.randint(0, cfg.vocab_size, (1, gc["seq"]), generator=gen,
                         device=DEVICE)
    nowin = dataclasses.replace(cfg32, attn_window=0)
    chk = family_check(state, cfg32, p4, toks, lambda: transformer
                       .prefill_forward(nowin, p4, {"tokens": toks}),
                       "attn_window=0 (every layer global)")
    chk.update(depth_cut=dict(layers=gc["layers"], of=cfg.num_layers),
               window=cfg.attn_window,
               keys_hidden_from_last_row=gc["seq"] - cfg.attn_window)
    del params, p4
    free_model()
    emit("lm_families", model=cfg.name, family=cfg.family,
         layers=cfg.num_layers, d_model=cfg.d_model, **init, main=serve,
         int8_kv=int8, check=chk, seconds=time.perf_counter() - t0)

    # (c) mamba2-1.3b and (d) qwen2-vl-2b at full width and depth
    for spec in (MAMBA, QWEN):
        t0 = time.perf_counter()
        cfg = get_config(spec["arch"])
        params, gen, init = family_params(cfg, 24)
        pos = None
        if cfg.use_mrope:
            pos = vlm_positions(spec["batch"], spec["seq"], spec["patch"],
                                spec["patch_at"])
        serve = family_serve(state, cfg, params, gen, batch=spec["batch"],
                             seq=spec["seq"], decode=spec["decode"], pos=pos)
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        toks = torch.randint(0, cfg.vocab_size, (FAMILY_CHECK["batch"],
                                                 FAMILY_CHECK["seq"]),
                             generator=gen, device=DEVICE)
        chk = rounded_check(state, cfg32, params, toks)
        del params
        free_model()
        emit("lm_families", model=cfg.name, family=cfg.family,
             layers=cfg.num_layers, d_model=cfg.d_model, **init, main=serve,
             check=chk, positions=("image block of %d x %d patches at "
                                   "tokens %d-%d, then text" % (
                                       spec["patch"], spec["patch"],
                                       spec["patch_at"], spec["patch_at"]
                                       + spec["patch"] ** 2 - 1)
                                   if pos is not None else None),
             seconds=time.perf_counter() - t0)

    # (e) the other dense configs at full width, cut in depth
    dc = DENSE_CUT
    for arch in dc["archs"]:
        t0 = time.perf_counter()
        full = get_config(arch)
        cfg = dataclasses.replace(full, num_layers=dc["layers"])
        params, gen, init = family_params(cfg, 25)
        serve = family_serve(state, cfg, params, gen, batch=dc["batch"],
                             seq=dc["seq"], decode=dc["decode"])
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        toks = torch.randint(0, cfg.vocab_size, (1, dc["check_seq"]),
                             generator=gen, device=DEVICE)
        chk = rounded_check(state, cfg32, params, toks)
        del params
        free_model()
        emit("lm_families", model=arch, family=cfg.family,
             layers=cfg.num_layers, d_model=cfg.d_model,
             depth_cut=dict(layers=dc["layers"], of=full.num_layers),
             heads=dict(q=cfg.padded_heads, kv=cfg.padded_kv_heads,
                        head_dim=cfg.head_dim),
             **init, main=serve, check=chk,
             seconds=time.perf_counter() - t0)
    emit("lm_families_done", seconds=time.perf_counter() - t_phase,
         clocks="host clock between device synchronizations; "
                "prefill_ms_first includes first-call cuBLAS set-up; peaks "
                "are torch.cuda.max_memory_allocated since the model's "
                "prefill")


# ---------------------------------------------------------------------------
# Phase 12c: the moe and encdec families
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def counted_drops():
    """Within: one record a moe layer call, (tokens routed, (token, k)
    pairs, pairs dropped as a device tensor), read after the run (no sync
    inside the path)."""
    recs = []
    slots = moe_mod._slots

    def counting(cfg, idx, *expert_range):
        slot, valid, cap = slots(cfg, idx, *expert_range)
        recs.append((idx.shape[0], valid.numel(), (~valid).sum()))
        return slot, valid, cap

    moe_mod._slots = counting
    try:
        yield recs
    finally:
        moe_mod._slots = slots


def drop_shares(recs, prefill_tokens: int, layers: int) -> dict:
    """The dropped share of the prefills' records (``prefill_tokens``
    routed a layer) and of the decode steps' (B a layer), and the most a
    decode step dropped."""
    def share(rs):
        dropped = sum(int(r[2]) for r in rs)
        pairs = sum(r[1] for r in rs)
        return dict(dropped=dropped, pairs=pairs,
                    share=dropped / pairs if pairs else None)

    pre = [r for r in recs if r[0] == prefill_tokens]
    dec = [r for r in recs if r[0] != prefill_tokens]
    steps = [share(dec[i:i + layers]) for i in range(0, len(dec), layers)]
    return dict(prefill=share(pre), decode=share(dec),
                decode_step_share_max=max((st["share"] for st in steps),
                                          default=None),
                decode_tokens_per_layer_call=dec[0][0] if dec else None)


def moe_no_drop_check(state, cfg, params, gen, batch: int, seq: int) -> dict:
    """The float32 check of a moe config at the capacity factor E / K,
    where every expert has a slot for every token (the prefill and the
    decode steps then route alike): no pair may drop."""
    cf = cfg.num_experts / cfg.experts_per_token
    cfg32 = dataclasses.replace(cfg, dtype="float32", capacity_factor=cf)
    toks = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                         device=DEVICE)
    with counted_drops() as recs:
        chk = rounded_check(state, cfg32, params, toks)
    dropped = sum(int(r[2]) for r in recs)
    check(dropped == 0, f"lm_moe_encdec[{cfg.name} check]: {dropped} "
          f"pairs dropped at the no-drop capacity factor {cf}")
    chk.update(capacity_factor=cf, pairs_dropped=dropped)
    return chk


def phase_lm_moe_encdec(state) -> None:
    t_phase = time.perf_counter()
    free_model()

    # (f) phi3.5-moe-42b-a6.6b and (g) qwen3-moe-235b-a22b at full width,
    # cut in depth
    for spec, seed in ((PHI_MOE, 26), (QWEN_MOE, 27)):
        t0 = time.perf_counter()
        full = get_config(spec["arch"])
        cfg = dataclasses.replace(full, num_layers=spec["layers"])
        params, gen, init = family_params(cfg, seed)
        with counted_drops() as recs:
            serve = family_serve(state, cfg, params, gen,
                                 batch=spec["batch"], seq=spec["seq"],
                                 decode=spec["decode"])
        drops = drop_shares(recs, spec["batch"] * spec["seq"],
                            cfg.num_layers)
        check(drops["prefill"]["dropped"] + drops["decode"]["dropped"] > 0,
              f"lm_moe_encdec[{cfg.name}]: no pair dropped at capacity "
              f"factor {cfg.capacity_factor}: {drops}")
        int8 = None
        if "int8_batch" in spec:
            int8 = int8_against_float(
                dataclasses.replace(cfg, capacity_factor=KV_INT8_MOE_CF),
                params, gen, spec["int8_batch"], spec["int8_steps"])
            int8["capacity_factor"] = KV_INT8_MOE_CF
        chk = moe_no_drop_check(state, cfg, params, gen, *spec["check"])
        del params
        free_model()
        emit("lm_moe_encdec", model=cfg.name, family=cfg.family,
             layers=cfg.num_layers, d_model=cfg.d_model,
             depth_cut=dict(layers=cfg.num_layers, of=full.num_layers),
             heads=dict(q=cfg.padded_heads, kv=cfg.padded_kv_heads,
                        head_dim=cfg.head_dim),
             experts=dict(num=cfg.num_experts, per_token=cfg.experts_per_token,
                          d_ff=cfg.d_ff, capacity_factor=cfg.capacity_factor),
             **init, main=serve, drops=drops, int8_kv=int8, check=chk,
             drop_counting="one sum a layer call, on through the serve run",
             seconds=time.perf_counter() - t0)

    # (h) whisper-small at full width and depth, over random frames
    t0 = time.perf_counter()
    w = WHISPER
    cfg = get_config(w["arch"])
    params, gen, init = family_params(cfg, 28)
    frames = torch.randn((w["batch"], cfg.encoder_seq, cfg.d_model),
                         generator=gen, device=DEVICE)
    serve = family_serve(state, cfg, params, gen, batch=w["batch"],
                         seq=w["seq"], decode=w["decode"], frames=frames)
    b, s = w["check"]
    toks = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                         device=DEVICE)
    chk = rounded_check(state, dataclasses.replace(cfg, dtype="float32"),
                        params, toks, frames=frames[:b])
    del params, frames
    free_model()
    emit("lm_moe_encdec", model=cfg.name, family=cfg.family,
         layers=dict(encoder=cfg.encoder_layers, decoder=cfg.num_layers),
         d_model=cfg.d_model, encoder_frames=cfg.encoder_seq,
         heads=dict(q=cfg.padded_heads, kv=cfg.padded_kv_heads,
                    head_dim=cfg.head_dim),
         **init, main=serve, check=chk,
         frames="seeded random embeddings (the reference's stub front end)",
         seconds=time.perf_counter() - t0)
    emit("lm_moe_encdec_done", seconds=time.perf_counter() - t_phase,
         clocks="host clock between device synchronizations; "
                "prefill_ms_first includes first-call cuBLAS set-up; peaks "
                "are torch.cuda.max_memory_allocated since the model's "
                "prefill")


# ---------------------------------------------------------------------------
# Phase 12d: training (gradients through both LM kernels, AdamW, GaLore,
# the loop)
# ---------------------------------------------------------------------------

# (a) zamba2-2.7b at full width cut to 12 layers (2 shared-block groups),
# float32, 2 x 256 tokens: every leaf's gradient through the kernels
# against autograd of the plain versions (per leaf max|d| <= rel *
# max|g|); the flash backward alone at gemma2-9b's local layer past its
# window and at whisper's 448 queries over 1,500 (ragged) keys.
TRAIN_GRAD = dict(layers=12, batch=2, seq=256, rel=1e-3)
FLASH_BWD_REL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
FLASH_BWD_GEMMA_SEQ = 5120
# (b) zamba2-2.7b at full depth: the launcher's defaults (global batch 8 x
# seq 512, lr 3e-4, warmup max(10, steps // 20), remat "dots"), bf16
# compute over float32 master weights, AdamW.
LM_TRAIN = dict(batch=8, seq=512, steps=6, remat="dots")
# (c) examples/gradient_compression.py's model, in float32, GaLore rank 16.
GALORE_CARD = dict(steps=2, rel=1e-4)
# (d) the loop on zamba2's smoke config: 2 x 5 steps with a restart
# against 10 straight, the reference's tolerance.
RESUME = dict(steps=10, half=5, rtol=1e-4, atol=1e-5, seq=64, batch=4)


def galore_example_config(dtype="bfloat16"):
    """examples/gradient_compression_torch.py's model (d_model 256, 4
    layers, vocab 8,192)."""
    return dataclasses.replace(
        get_smoke_config("phi4-mini-3.8b"), num_layers=4, d_model=256,
        num_heads=4, num_kv_heads=2, head_dim=64, d_ff=1024, vocab_size=8192,
        dtype=dtype)


@contextlib.contextmanager
def plain_lm_kernels():
    """Within: the models call the plain versions of both LM kernels
    directly (autograd through their torch ops)."""
    saved = kernel_ops.flash_attention, kernel_ops.ssd_scan
    kernel_ops.flash_attention = fa_mod.flash_attention_ref
    kernel_ops.ssd_scan = ss_mod.ssd_scan_ref
    try:
        yield
    finally:
        kernel_ops.flash_attention, kernel_ops.ssd_scan = saved


@contextlib.contextmanager
def event_timed(targets):
    """Within: each ``(owner, attribute)`` of ``targets`` (label ->) timed
    by a CUDA event pair around every call; at exit the dict yielded
    holds {label: {calls, ms}}, the device time between the events summed
    (a custom Function's ``backward`` is looked up at call time, so it is
    timed too)."""
    pairs = {label: [] for label in targets}
    saved = {}
    for label, (owner, attr) in targets.items():
        saved[label] = owner.__dict__[attr]
        fn = getattr(owner, attr)

        def wrap(*a, _fn=fn, _label=label, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = _fn(*a, **kw)
            end.record()
            pairs[_label].append((start, end))
            return out

        setattr(owner, attr,
                staticmethod(wrap) if isinstance(owner, type) else wrap)
    times = {}
    try:
        yield times
    finally:
        for label, (owner, attr) in targets.items():
            setattr(owner, attr, saved[label])
        torch.cuda.synchronize()
        for label, ps in pairs.items():
            times[label] = dict(calls=len(ps), ms=sum(
                a.elapsed_time(b) for a, b in ps))


def leaf_grads(cfg, params, batch, remat="none"):
    """(loss, leaf paths, gradients) of ``train_loss`` over every
    parameter leaf, as the train step takes them (zeros where the loss
    does not reach a leaf)."""
    loss, _, grads = train_step._grads(
        cfg, train_step.TrainConfig(remat=remat), params, batch)
    flat = ptree.flatten(grads)
    return float(loss), [name for name, _ in flat], [g for _, g in flat]


def grads_against(label, names, got, want, rel) -> dict:
    """Per leaf max|got - want| / max|want|; the worst over ``rel``.  A
    leaf with no gradient or an all-zero one fails the run."""
    per_leaf = {}
    for name, g, w in zip(names, got, want):
        check(g is not None and w is not None,
              f"{label}: {name} got no gradient")
        check(bool(g.abs().max() > 0), f"{label}: {name}'s gradient is all "
              f"zero")
        per_leaf[name] = max_err(g, w) / float(w.abs().max())
    worst = max(per_leaf, key=per_leaf.get)
    return dict(worst_leaf=worst, worst_err_over_max=per_leaf[worst],
                worst_over_limit=per_leaf[worst] / rel,
                err_over_max=per_leaf)


def train_grads_check(state) -> dict:
    """(a): the 12-layer float32 model's gradients through the kernels
    against the plain versions', and the control."""
    tg = TRAIN_GRAD
    cfg = dataclasses.replace(get_config(LM_ARCH), num_layers=tg["layers"],
                              dtype="float32")
    params = schema.init_params(cfg, torch.Generator(DEVICE).manual_seed(30),
                                DEVICE)
    dcfg = data_mod.DataConfig(cfg.vocab_size, tg["seq"], tg["batch"])
    batch = data_mod.shard_batch(data_mod.batch_at(dcfg, 0), DEVICE)
    groups = cfg.num_layers // cfg.hybrid_attn_every
    reset_counts()
    (loss_k, names, g_k), ms_k = synced_ms(
        lambda: leaf_grads(cfg, params, batch))
    counts = read_counts()
    keep_counts(state, "lm_train[grads, 12 layers f32]", counts)
    check(counts["flash_attention"] == groups
          and counts["ssd_scan"] == cfg.num_layers,
          f"lm_train: a float32 gradient launched {counts} (want "
          f"flash_attention {groups}, ssd_scan {cfg.num_layers})")
    with plain_lm_kernels():
        (loss_p, _, g_p), ms_p = synced_ms(
            lambda: leaf_grads(cfg, params, batch))
    held = grads_against("lm_train[grads]", names, g_k, g_p, tg["rel"])
    check(held["worst_over_limit"] <= 1.0,
          f"lm_train: leaf {held['worst_leaf']}'s gradient through the "
          f"kernels errs {held['worst_err_over_max']} of max > {tg['rel']}")
    del g_k
    with bf16_rounded_kernels():
        _, _, g_c = leaf_grads(cfg, params, batch)
    control = grads_against("lm_train[grads control]", names, g_c, g_p,
                            tg["rel"])
    check(control["worst_over_limit"] > 1.0,
          f"lm_train: the control (bf16-rounded kernel inputs) stays within "
          f"the limit ({control['worst_err_over_max']} of max): the check "
          f"cannot tell")
    del g_c, g_p, params
    free_model()
    return dict(model=f"{cfg.name} cut to {cfg.num_layers} layers float32",
                tokens=[tg["batch"], tg["seq"]], leaves=len(names),
                loss_kernels=loss_k, loss_plain=loss_p, launches=counts,
                limit=f"per leaf max|d| <= {tg['rel']} x max|g|",
                worst_leaf=held["worst_leaf"],
                worst_err_over_max=held["worst_err_over_max"],
                control_worst_leaf=control["worst_leaf"],
                control_worst_err_over_max=control["worst_err_over_max"],
                grads_ms=ms_k, plain_grads_ms=ms_p,
                err_over_max_by_leaf=held["err_over_max"])


def flash_bwd_checks(gen) -> list:
    """The flash backward alone (through the Function, the kernel's
    forward) against autograd of the plain version, float32 and bf16:
    gemma2-9b's local layer past its window, whisper's cross-attention."""
    g2, wh = get_config(WIDE_ATTN_ARCH), get_config(WHISPER["arch"])
    specs = (
        (f"{WIDE_ATTN_ARCH} 1 x {g2.padded_heads}/{g2.padded_kv_heads} x "
         f"{FLASH_BWD_GEMMA_SEQ}, head dim {g2.head_dim}, window "
         f"{g2.attn_window}, softcap {g2.logit_softcap:g}",
         (1, g2.padded_heads, g2.padded_kv_heads, FLASH_BWD_GEMMA_SEQ,
          FLASH_BWD_GEMMA_SEQ, g2.head_dim),
         dict(window=g2.attn_window, softcap=g2.logit_softcap)),
        (f"whisper-small cross {WHISPER['batch']} x {wh.padded_heads} x "
         f"{WHISPER['seq']} over {wh.encoder_seq} keys, non-causal",
         (WHISPER["batch"], wh.padded_heads, wh.padded_kv_heads,
          WHISPER["seq"], wh.encoder_seq, wh.head_dim), dict(causal=False)))
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).replace("torch.", "")
        for name, (b, hq, hkv, sq, sk, d), kw in specs:
            q = lm_randn((b, hq, sq, d), gen, dtype).requires_grad_()
            k = lm_randn((b, hkv, sk, d), gen, dtype).requires_grad_()
            v = lm_randn((b, hkv, sk, d), gen, dtype).requires_grad_()
            dout = lm_randn((b, hq, sq, d), gen, dtype)
            got = torch.autograd.grad(fa_mod.flash_attention(q, k, v, **kw),
                                      (q, k, v), dout)
            want = torch.autograd.grad(
                fa_mod.flash_attention_ref(q, k, v, **kw), (q, k, v), dout)
            errs = {x: max_err(g_, w_) / float(w_.abs().max())
                    for x, g_, w_ in zip(("dq", "dk", "dv"), got, want)}
            limit = FLASH_BWD_REL[dtype]
            rows.append(dict(case=f"{name} {tag}", err_over_max=errs,
                             limit=limit))
            check(all(torch.isfinite(g_).all() for g_ in got)
                  and max(errs.values()) <= limit,
                  f"lm_train: flash backward [{name} {tag}] errs {errs} of "
                  f"max > {limit}")
            del q, k, v, dout, got, want
            torch.cuda.empty_cache()
    return rows


def backward_rows(gen) -> dict:
    """The two backwards (torch ops, not kernels) at zamba2's training
    shape, timed beside their bound (2.5x the forward's operations at the
    bf16 tensor-core peak), the plain versions' autograd and, for
    attention, SDPA's backward."""
    cfg = get_config(LM_ARCH)
    b, s = LM_TRAIN["batch"], LM_TRAIN["seq"]
    dt = torch.bfloat16
    q = lm_randn((b, cfg.padded_heads, s, cfg.head_dim), gen, dt)
    k = lm_randn((b, cfg.padded_kv_heads, s, cfg.head_dim), gen, dt)
    v = lm_randn((b, cfg.padded_kv_heads, s, cfg.head_dim), gen, dt)
    dout = lm_randn(q.shape, gen, dt)
    out, lse = fa_mod._forward(q, k, v, True, 0, 0.0,
                               cfg.head_dim ** -0.5, True)
    _, _, fwd_flops, _ = flash_bound(q, k)
    ms = time_ms(lambda: fa_mod.flash_attention_bwd(q, k, v, out, lse, dout))
    qr, kr, vr = (x.detach().requires_grad_() for x in (q, k, v))
    plain_out = fa_mod.flash_attention_ref(qr, kr, vr)
    plain_ms = time_ms(lambda: torch.autograd.grad(
        plain_out, (qr, kr, vr), dout, retain_graph=True), iters=3, warmup=1)
    del plain_out
    sdpa_out = torch.nn.functional.scaled_dot_product_attention(
        qr, kr, vr, is_causal=True)
    library_ms = time_ms(lambda: torch.autograd.grad(
        sdpa_out, (qr, kr, vr), dout, retain_graph=True))
    del sdpa_out
    flash = dict(name="flash_attention backward (torch ops, not a kernel)",
                 source="src/repro_torch/kernels/flash_attention.py:"
                        "flash_attention_bwd",
                 shape=f"q, k, v {tuple(q.shape)} bf16 causal", ms=ms,
                 plain_ms=plain_ms, bound_ms=2.5 * fwd_flops / BF16_FLOPS
                 * 1e3, bound_by="operations (2.5x the forward's)",
                 library_ms=library_ms,
                 library="SDPA backward (K, V at the query heads' count)")
    del q, k, v, dout, out, lse, qr, kr, vr
    x, dtt, a, bm, cm = ssd_inputs(b, s, cfg.ssm_heads, cfg.ssm_groups,
                                   cfg.ssm_head_dim, cfg.ssm_state, dt, gen)
    ins = [t.requires_grad_() for t in (x, dtt, a, bm, cm)]
    y, h_fin = ss_mod.ssd_scan(*ins)
    gy = lm_randn(y.shape, gen, dt)
    ms = time_ms(lambda: torch.autograd.grad(y, ins, gy, retain_graph=True))
    y_r, _ = ss_mod.ssd_scan_ref(*ins)
    plain_ms = time_ms(lambda: torch.autograd.grad(y_r, ins, gy,
                                                   retain_graph=True),
                       iters=2, warmup=1)
    _, fwd_flops = ss_mod.work(b, s, cfg.ssm_heads, cfg.ssm_groups,
                               cfg.ssm_head_dim, cfg.ssm_state, 2)
    ssd = dict(name="ssd_scan backward (torch ops, not a kernel)",
               source="src/repro_torch/kernels/ssd_scan.py:SSDScan.backward "
                      "(ssd_scan_chunked recomputed under autograd)",
               shape=f"x {tuple(x.shape)} bf16, G {cfg.ssm_groups}, N "
                     f"{cfg.ssm_state}",
               ms=ms, plain_ms=plain_ms,
               bound_ms=2.5 * fwd_flops / BF16_FLOPS * 1e3,
               bound_by="operations (2.5x the forward's)", library_ms=None)
    del ins, y, h_fin, gy, y_r
    free_model()
    return dict(flash_attention=flash, ssd_scan=ssd)


def kernel_category(name: str) -> str:
    if "attn_kernel" in name:
        return "flash_attention kernel"
    if "ssd" in name:
        return "ssd_scan kernel"
    if "gemm" in name or "sm90_xmma" in name or "cutlass" in name \
            or "cublas" in name.lower():
        return "cuBLAS"
    return "other"


def profile_step(fn) -> dict:
    """Device time by kernel over one call of ``fn`` (``torch.profiler``):
    the kernels' own records, by category and the ten largest."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall_ms = synced_ms(fn)
    rows, by_cat = [], {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA or \
                ev.key.startswith("Command Buffer"):
            continue
        dev = getattr(ev, "self_device_time_total",
                      getattr(ev, "self_cuda_time_total", 0.0)) / 1e3
        if dev > 0:
            rows.append((dev, ev.key, ev.count))
            cat = kernel_category(ev.key)
            by_cat[cat] = by_cat.get(cat, 0.0) + dev
    rows.sort(reverse=True)
    total = sum(r[0] for r in rows) if rows else None
    return dict(kernel_ms_total=total, profiled_wall_ms=wall_ms,
                device_ms_by_category=by_cat,
                top=[dict(name=k[:80], device_ms=ms, calls=n)
                     for ms, k, n in rows[:10]])


def train_full_depth(state) -> dict:
    """(b): zamba2-2.7b at full depth, 6 steps, launch counts a step
    checked, then one step timed by part and one profiled."""
    cfg = get_config(LM_ARCH)
    lt = LM_TRAIN
    tcfg = train_step.TrainConfig(remat=lt["remat"],
                                  warmup_steps=max(10, 100 // 20),
                                  total_steps=100)
    gen = torch.Generator(DEVICE).manual_seed(31)
    torch.cuda.reset_peak_memory_stats()
    tstate, init_ms = synced_ms(
        lambda: train_step.init_train_state(cfg, tcfg, gen, DEVICE))
    n_params = schema.param_count_actual(tstate["params"])
    after_init = torch.cuda.memory_allocated()
    dcfg = data_mod.DataConfig(cfg.vocab_size, lt["seq"], lt["batch"])
    step_fn = train_step.make_train_step(cfg, tcfg)
    groups = cfg.num_layers // cfg.hybrid_attn_every
    want = dict(flash_attention=2 * groups, ssd_scan=2 * cfg.num_layers)
    steps = []
    for i in range(lt["steps"]):
        batch = data_mod.shard_batch(data_mod.batch_at(dcfg, i), DEVICE)
        reset_counts()
        (tstate, metrics), ms = synced_ms(lambda: step_fn(tstate, batch))
        counts = read_counts()
        if i == 0:
            keep_counts(state, "lm_train[zamba2-2.7b step]", counts)
        check(all(counts[kk] == vv for kk, vv in want.items()),
              f"lm_train: step {i} launched {counts}, want {want} (forward + "
              f"the remat's recompute)")
        row = dict(step=i, ms=ms, **{kk: float(vv) for kk, vv in
                                     metrics.items()})
        check(all(np.isfinite(vv) for vv in row.values()),
              f"lm_train: step {i} metrics not finite: {row}")
        steps.append(row)
    peak = torch.cuda.max_memory_allocated()
    med = float(np.median([r["ms"] for r in steps[1:]]))
    state.setdefault("measured", {})[f"{cfg.name} train step"] = dict(
        ms=med, least_ms=min(r["ms"] for r in steps[1:]),
        batch=lt["batch"], seq=lt["seq"], tcfg=tcfg)
    batch = data_mod.shard_batch(data_mod.batch_at(dcfg, lt["steps"]),
                                 DEVICE)
    with event_timed({
            "grads (forward + backward)": (train_step, "_grads"),
            "flash_attention backward": (fa_mod.FlashAttention, "backward"),
            "ssd_scan backward": (ss_mod.SSDScan, "backward"),
            "adamw": (adamw_mod, "apply_updates")}) as parts:
        (tstate, _), part_wall = synced_ms(lambda: step_fn(tstate, batch))
    batch = data_mod.shard_batch(data_mod.batch_at(dcfg, lt["steps"] + 1),
                                 DEVICE)
    prof = profile_step(lambda: step_fn(tstate, batch))
    del tstate, batch
    free_model()
    tokens = lt["batch"] * lt["seq"]
    return dict(model=cfg.name, params=n_params, init_ms=init_ms,
                tokens_a_step=tokens, remat=lt["remat"], optimizer="adamw",
                compute_dtype=cfg.dtype, master_weights="float32",
                steps=steps, ms_a_step_median_2_to_6=med,
                tokens_per_s=tokens / med * 1e3,
                losses=[r["loss"] for r in steps],
                peak_bytes=peak, bytes_after_init=after_init,
                launches_a_step=want,
                parts_of_one_step=dict(wall_ms=part_wall, **parts),
                backward_share_of_step=(
                    parts["flash_attention backward"]["ms"]
                    + parts["ssd_scan backward"]["ms"]) / part_wall,
                profile=prof)


@contextlib.contextmanager
def basis_gaps(rank: int):
    """Within: each GaLore basis computed also records the smallest gap
    between its gram's top ``rank`` + 1 eigenvalues, over the largest
    (what decides whether two eigh calls give the same columns)."""
    gaps = []
    basis = galore_mod.mesh_basis

    def recording(gcfg, g, spec=(), ctx=None, cols=None):
        out = basis(gcfg, g, spec, ctx, cols)
        g32 = g.to(torch.float32)
        ev = torch.linalg.eigvalsh(g32 @ g32.transpose(-1, -2)).flip(-1)
        top = ev[..., : rank + 1]
        gaps.append(float(((top[..., :-1] - top[..., 1:])
                           / top[..., :1]).min()))
        return out

    galore_mod.mesh_basis = recording
    try:
        yield gaps
    finally:
        galore_mod.mesh_basis = basis


def galore_on_card(state) -> dict:
    """(c): GaLore on the card against the port's CPU run from the same
    parameters; the repair columns are drawn on the CPU on both sides.
    After the refresh step the bases are compared after a sign fix (each
    column's sign set by its dot product with the CPU's), beside their
    grams' eigenvalue gaps; then the CPU run's bases and moments are
    carried to the card, so that the next step's parameters compare the
    rest of the step (an eigh's columns are free inside a near-degenerate
    eigenspace, and Adam's direction is not rotation-invariant)."""
    cfg = galore_example_config("float32")
    gc = GALORE_CARD
    tcfg = train_step.TrainConfig(
        optimizer="galore", remat="none",
        adamw=adamw_mod.AdamWConfig(lr=1e-3),
        galore=galore_mod.GaloreConfig(rank=16, update_every=20),
        warmup_steps=10, total_steps=120)
    card = train_step.init_train_state(
        cfg, tcfg, torch.Generator(DEVICE).manual_seed(32), DEVICE)
    cpu_params = ptree.tree_map(lambda p: p.cpu(), card["params"])
    cpu = {"params": cpu_params,
           "opt": train_step.init_opt_state(tcfg, cpu_params),
           "seed": card["seed"]}
    adam_bytes = sum(x.numel() * x.element_size() for x in ptree.leaves(
        train_step.init_opt_state(dataclasses.replace(
            tcfg, optimizer="adamw"), cpu_params)))
    dcfg = data_mod.DataConfig(cfg.vocab_size, 256, 8, alphabet=32)
    step_fn = train_step.make_train_step(cfg, tcfg)
    rows = []
    for i in range(gc["steps"]):
        host = data_mod.batch_at(dcfg, i)
        reset_counts()
        with event_timed({"galore": (galore_mod, "apply_updates")}) as t:
            (card, _), ms = synced_ms(lambda: step_fn(
                card, data_mod.shard_batch(host, DEVICE)))
        counts = read_counts()
        t0 = time.perf_counter()
        cpu, _ = step_fn(cpu, data_mod.shard_batch(host, "cpu"))
        cpu_s = time.perf_counter() - t0
        params_err = {path: max_err(a.cpu(), b) / float(b.abs().max())
                      for (path, a), b in zip(ptree.flatten(card["params"]),
                                              ptree.leaves(cpu["params"]))}
        refresh = i % tcfg.galore.update_every == 0
        basis = {}
        if refresh:
            # the step's gradient again (the warmup's lr is 0 at step 0, so
            # the parameters have not moved), its grams' eigenvalue gaps
            g = train_step._grads(cfg, tcfg, card["params"],
                                  data_mod.shard_batch(host, DEVICE))[2]
            with basis_gaps(tcfg.galore.rank) as gaps:
                for path, leaf in ptree.flatten(g):
                    if galore_mod.eligible(tcfg.galore, leaf):
                        m, n = leaf.shape[-2:]
                        galore_mod.mesh_basis(
                            tcfg.galore, leaf,
                            cols=galore_mod.draw_cols(0, 0, m, n))
            del g
            eligible = [path for path, p in ptree.flatten(cpu["params"])
                        if "p" in galore_mod._leaf_state(
                            cpu["opt"]["leaves"], path)]
            for path, gap in zip(eligible, gaps):
                st_c = galore_mod._leaf_state(cpu["opt"]["leaves"], path)
                st_g = galore_mod._leaf_state(card["opt"]["leaves"], path)
                pc, pg = st_c["p"], st_g["p"].cpu()
                sign = torch.sign((pc * pg).sum(dim=-2, keepdim=True))
                basis[path] = dict(
                    err_over_max=max_err(pg * sign, pc) / float(
                        pc.abs().max()), min_top_eigengap=gap)
                for key in ("p", "m", "v"):      # the CPU's bases carried
                    st_g[key].copy_(st_c[key])
        worst = max(params_err, key=params_err.get)
        rows.append(dict(step=i, refresh=refresh, step_ms=ms,
                         galore_apply_ms=t["galore"]["ms"],
                         cpu_step_s=cpu_s, launches=counts,
                         params_worst_leaf=worst,
                         params_err_over_max=params_err[worst],
                         basis_after_sign_fix=basis))
        check(params_err[worst] <= gc["rel"],
              f"lm_train[galore]: step {i}: parameters on the card err "
              f"{params_err} of max against the CPU run > {gc['rel']}; "
              f"bases {basis}")
    gbytes = galore_mod.state_bytes(card["opt"])
    check(rows[0]["launches"]["flash_attention"] >= 1,
          "lm_train[galore]: the model launched no flash_attention")
    del card, cpu
    free_model()
    return dict(model="examples/gradient_compression_torch.py's (d_model "
                      "256, 4 layers, vocab 8,192) float32",
                rank=16, steps=rows, refresh_ms=rows[0]["galore_apply_ms"],
                no_refresh_ms=rows[1]["galore_apply_ms"],
                galore_state_bytes=gbytes, adamw_state_bytes=adam_bytes,
                limit=f"params per leaf max|d| <= {gc['rel']} x max|p|")


def resume_on_card(state) -> dict:
    """(d): the loop 2 x 5 steps with a restart against 10 straight."""
    import tempfile
    cfg = get_smoke_config(LM_ARCH)
    rs = RESUME
    tcfg = train_step.TrainConfig(remat="dots",
                                  adamw=adamw_mod.AdamWConfig(lr=1e-3))
    dcfg = data_mod.DataConfig(cfg.vocab_size, rs["seq"], rs["batch"])
    logs = []
    reset_counts()
    with tempfile.TemporaryDirectory() as tmp:
        def run(name, steps):
            lcfg = train_loop.LoopConfig(steps=steps, ckpt_every=rs["half"],
                                         ckpt_dir=os.path.join(tmp, name),
                                         log_every=100)
            return train_loop.train(cfg, tcfg, lcfg, dcfg, device=DEVICE,
                                    log=logs.append)
        straight = run("a", rs["steps"])
        run("b", rs["half"])
        resumed = run("b", rs["steps"])
    counts = read_counts()
    keep_counts(state, "lm_train[resume]", counts)
    check("resumed from step 5" in logs, f"lm_train[resume]: {logs}")
    worst, equal = 0.0, True
    for a, b in zip(ptree.leaves(straight["params"]),
                    ptree.leaves(resumed["params"])):
        equal &= torch.equal(a, b)
        ok = torch.allclose(a, b, rtol=rs["rtol"], atol=rs["atol"])
        check(ok, f"lm_train[resume]: resumed params differ by "
              f"{max_err(a, b)}")
        worst = max(worst, max_err(a, b))
    check(counts["flash_attention"] >= 1 and counts["ssd_scan"] >= 1,
          f"lm_train[resume]: launches {counts}")
    return dict(model=cfg.name, steps=f"{rs['half']} + {rs['half']} after a "
                f"restart vs {rs['steps']} straight", max_abs_err=worst,
                bits_equal=bool(equal), launches=counts,
                limit=f"rtol {rs['rtol']}, atol {rs['atol']}")


def phase_lm_train(state) -> None:
    t_phase = time.perf_counter()
    free_model()
    gen = torch.Generator(DEVICE).manual_seed(33)
    t0 = time.perf_counter()
    grads = train_grads_check(state)
    grads["flash_backward_checks"] = flash_bwd_checks(gen)
    grads["backwards"] = backward_rows(gen)
    state["backward_rows"] = grads["backwards"]
    emit("lm_train", case="(a) gradients on the card", **grads,
         seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    emit("lm_train", case="(b) zamba2-2.7b full depth",
         **train_full_depth(state), seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    emit("lm_train", case="(c) Ranky-GaLore", **galore_on_card(state),
         seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    emit("lm_train", case="(d) resume", **resume_on_card(state),
         seconds=time.perf_counter() - t0)
    emit("lm_train_done", seconds=time.perf_counter() - t_phase,
         clocks="host clock between device synchronizations unless a "
                "field says device (CUDA events, torch.profiler); peaks are "
                "torch.cuda.max_memory_allocated since the model's init")


# ---------------------------------------------------------------------------
# Phases 13-15: checkpoints, the observability layer, the example twins
# ---------------------------------------------------------------------------

# Phases 13-14: the user's stream (phase 9's configuration) on the kernels.
OBSERVE_CFG = dict(method="neighbor_random", truncate_rank=16, oversample=8,
                   num_blocks=NUM_BLOCKS, use_kernel=True)
OBSERVE_WAVES = 20
# The obs-off serving gate (the reference's, ``benchmarks/serving.py`` and
# ``scripts/check_bench_json.py``): interleaved pairs of a direct
# ``ranker.score_topk`` and ``serve_topk`` with obs off, the least p99 of
# the rounds within ``limit`` of the direct path's.  The reference takes
# at least 100 pairs a round; with 120,000 the p99 stands on 1,200 waves
# of each arm's tail, not on 1 or 2: on the H100's host a 500-pair p99
# moves by several percent between runs, and a round's p99 ratio by
# ~0.3 % (sd, at 60,000 and at 120,000 pairs alike;
# ``scripts/obs_gate_study_torch.py``), so that a 60,000-pair gate read
# over 1.01 now and then (1.0126) with no cost added to ``serve_topk``.
# 2,000 pairs of warm-up first.  The garbage collector is off while the
# pairs are timed (``obs_off_ab``).
OBS_AB = dict(rounds=3, pairs=120_000, warmup=2_000, limit=1.01)


def paper_batches(coo, dense=False):
    """The paper rows in batches of 64 (the last one shorter)."""
    m = coo.shape[0]
    bounds = list(range(0, m, STREAM_BATCH_ROWS)) + [m]
    out = [coo_rows(coo, lo, hi) for lo, hi in zip(bounds, bounds[1:])]
    return [b.todense() for b in out] if dense else out


def states_equal(a, b) -> bool:
    return (all(torch.equal(getattr(a, f), getattr(b, f))
                for f in ("u", "s", "v"))
            and (a.seed, a.n, a.num_blocks, a.rows_seen, a.batches_seen,
                 a.lonely_rows_seen, a.repaired_rows_seen)
            == (b.seed, b.n, b.num_blocks, b.rows_seen, b.batches_seen,
                b.lonely_rows_seen, b.repaired_rows_seen))


def phase_checkpoint(state) -> None:
    """A stream saved and restored on the card continues with the same
    bits, per batch and mid-window."""
    import tempfile
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.stream import window as sw

    coo = state["coo"]
    n = coo.shape[1]
    cfg = api.SolveConfig(**OBSERVE_CFG)
    batches = paper_batches(coo)
    reset_counts()
    st = api.svd_init(n, cfg, device=DEVICE)
    for delta in batches[:3]:
        st = api.svd_update(st, delta, cfg).state
    counts = read_counts()
    keep_counts(state, "checkpoint[ingest x3]", counts)
    check(counts["sparse_gram"] == 3, f"checkpoint: sparse_gram launched "
          f"{counts['sparse_gram']} times in 3 ingests")
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        ck = Checkpointer(tmp)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = ck.save(3, st, blocking=True)
        out["save_ms"] = (time.perf_counter() - t0) * 1e3
        out["file_bytes"] = os.path.getsize(os.path.join(path, "arrays.npz"))
        t0 = time.perf_counter()
        back, meta = ck.restore()             # device=None: the card
        torch.cuda.synchronize()
        out["restore_ms"] = (time.perf_counter() - t0) * 1e3
        check(back.device.type == "cuda", f"restored onto {back.device}")
        check(states_equal(st, back), "checkpoint: the restored state "
              "differs from the saved one")
        a, b = st, back
        for delta in batches[3:6]:
            a = api.svd_update(a, delta, cfg).state
            b = api.svd_update(b, delta, cfg).state
        check(states_equal(a, b), "checkpoint: three svd_updates from the "
              "restored state differ from those from the original")

        # A window resumed mid-stream: dense batches of one bucket.
        dense = [torch.from_numpy(x) for x in paper_batches(coo, dense=True)]
        group = dense[3:7]
        norm = stream_state.as_delta(group[0], st, device="cpu")
        sig = sw.bucket_signature(norm)
        spec = api.ASpec(m=sig[1], n=n, nnz=api._delta_nnz_estimate(norm),
                         num_blocks=NUM_BLOCKS, kind="stream")
        plan = api.planner.make_window_plan(
            spec, cfg, nnz_slots=sw.bucket_nnz_slots(sig, NUM_BLOCKS))
        check(plan.window >= len(group), f"checkpoint: R6 window "
              f"{plan.window} < {len(group)}")
        reset_counts()
        whole, _ = sw.ingest_window(st, group, cfg, plan)
        counts = read_counts()
        keep_counts(state, "checkpoint[window of 4]", counts)
        check(counts["blockgram"] == len(group), f"checkpoint: blockgram "
              f"launched {counts['blockgram']} times in a window of 4")
        half, _ = sw.ingest_window(st, group[:2], cfg, plan)
        ck.save(5, half, blocking=True)
        restored, _ = ck.restore(5)
        resumed, _ = sw.ingest_window(restored, group[2:], cfg, plan)
        check(states_equal(whole, resumed), "checkpoint: the window resumed "
              "from a restored state differs from the uninterrupted one")
        out["steps_kept"] = ck.list_steps()
    emit("checkpoint", rank=st.rank, rows_seen=st.rows_seen,
         state_shapes={f: list(getattr(st, f).shape) for f in ("u", "s", "v")},
         resumed_updates_equal=True, resumed_window_equal=True,
         window=dict(batches=len(group), bucket=list(sig)), **out,
         clocks="host clock; save: device to host copy + npz write "
                "(blocking); restore: read + host to device copy, the "
                "device synchronized")


def observe_pass(sparse_b, dense_b, queries) -> tuple:
    """One pass of phase 14: svd_stream of both streams, then the waves
    served from the sparse stream's state.  ((states, waves), numbers)."""
    from repro_torch.stream import window as sw

    cfg = api.SolveConfig(**OBSERVE_CFG)
    sw.clear_caches()
    reset_counts()
    nums = dict(ms_per_batch={}, host_syncs_per_batch={}, sync_sites={})
    results = {}
    for name, batches in (("sparse", sparse_b), ("dense", dense_b)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res, sites = sync_sites(lambda: api.svd_stream(iter(batches), cfg,
                                                       device=DEVICE))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        results[name] = res
        nums["ms_per_batch"][name] = secs / len(batches) * 1e3
        nums["host_syncs_per_batch"][name] = (sum(sites.values())
                                              / len(batches))
        nums["sync_sites"][name] = sites
        nums[f"{name}_wall_s"] = secs
    handle = api.serve_init(results["sparse"].state,
                            api.ServeTopKConfig(batch_size=32, k_top=10))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    waves, sites = sync_sites(lambda: [api.serve_topk(handle, q)
                                       for q in queries])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    nums["ms_per_batch"]["wave"] = secs / len(queries) * 1e3
    nums["host_syncs_per_batch"]["wave"] = sum(sites.values()) / len(queries)
    nums["sync_sites"]["wave"] = sites
    nums["waves_wall_s"] = secs
    nums["dispatch"] = sw.dispatch_counts()
    nums["trace_count"] = sw.trace_count()
    nums["launches"] = read_counts()
    return (results, waves, handle), nums


def observe_on_pass(sparse_b, dense_b, queries) -> tuple:
    """One pass of phase 14 with obs on (cleared first, off after): the
    pass and what obs recorded in it."""
    obs.enable()
    obs.reset()
    try:
        (res, waves, handle), nums = observe_pass(sparse_b, dense_b,
                                                  queries)
        rec = dict(metrics=handle.metrics(), events=obs.trace.events(),
                   ratios=obs.drift_ratios(),
                   diag=res["sparse"].diagnostics)
        rec["chrome"] = obs.chrome_trace(rec["events"])
        obs.validate_chrome_trace(rec["chrome"])
    finally:
        obs.disable()
        obs.reset()
    return (res, waves, handle), nums, rec


def obs_off_ab(handle, queries, *, arm: str = "served",
               order: str = "fixed", gate: bool = True) -> dict:
    """The obs-off gate on the card: ``serve_topk`` with obs off against
    the direct ``ranker.score_topk`` call it makes, in interleaved pairs
    (direct first, the reference's order), each call timed on the host
    clock up to a ``torch.cuda.synchronize()`` after it.  p50 / p99 in us
    a round; the gate holds the least p99 of the rounds.  The garbage
    collector is off while pairs are timed, as ``timeit`` keeps it, and
    collects between rounds.

    For ``scripts/obs_gate_study_torch.py``: ``order="alternate"`` runs
    ``serve_topk`` first in odd pairs; ``arm="direct"`` times the direct
    call against itself, an A/A control of the statistic's own noise;
    ``gate=False`` returns the numbers without holding them."""
    cfg = handle.config
    sharded = handle.plan.backend == "shard_map"

    def direct(q):
        return ranker.score_topk(handle.read(), q, cfg.k_top,
                                 block_n=cfg.block_n, sharded=sharded,
                                 use_kernel=cfg.use_kernel)

    def served(q):
        return api.serve_topk(handle, q)

    def timed(fn, q) -> float:
        t0 = time.perf_counter()
        fn(q)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e6

    check(arm in ("served", "direct") and order in ("alternate", "fixed"),
          f"observe: unknown A/B design arm={arm!r} order={order!r}")
    check(not obs.enabled(), "observe: obs is on for the obs-off gate")
    for q in queries:
        a, b = served(q), direct(q)
        check(torch.equal(a.scores, b.scores)
              and torch.equal(a.indices, b.indices), "observe: serve_topk "
              "with obs off differs from the direct ranker call")
    other = served if arm == "served" else direct
    flip = 1 if order == "alternate" else 0
    for w in range(OBS_AB["warmup"]):
        q = queries[w % len(queries)]
        timed(direct, q)
        timed(other, q)
    rounds = []
    gc.collect()
    gc.disable()
    try:
        for _ in range(OBS_AB["rounds"]):
            base, off = [], []
            for w in range(OBS_AB["pairs"]):
                q = queries[w % len(queries)]
                if w & flip:
                    off.append(timed(other, q))
                    base.append(timed(direct, q))
                else:
                    base.append(timed(direct, q))
                    off.append(timed(other, q))
            rounds.append({f"{q}_{name}_us": float(np.percentile(lat, pct))
                           for name, lat in (("base", base), ("off", off))
                           for q, pct in (("p50", 50), ("p99", 99))})
            gc.collect()
    finally:
        gc.enable()
    p99_base = min(r["p99_base_us"] for r in rounds)
    p99_off = min(r["p99_off_us"] for r in rounds)
    if gate:
        check(p99_off <= OBS_AB["limit"] * p99_base, f"observe: obs-off "
              f"serving p99 {p99_off:.1f} us > {OBS_AB['limit']} x the "
              f"direct path's {p99_base:.1f} us; rounds {rounds}")
    return dict(**OBS_AB, arm=arm, order=order, p99_base_us=p99_base,
                p99_off_us=p99_off, ratio=p99_off / p99_base,
                p50_base_us=min(r["p50_base_us"] for r in rounds),
                p50_off_us=min(r["p50_off_us"] for r in rounds),
                by_round=rounds,
                clocks="host clock around each call up to a "
                       "torch.cuda.synchronize() after it")


def phase_observe(state) -> None:
    """The observability layer on the card changes no result and adds no
    host sync; it records R5 / R6 / R7 drift within the factor.  After an
    obs-off warm-up pass, passes run off, on, on, off."""
    coo = state["coo"]
    sparse_b = paper_batches(coo)
    dense_b = [torch.from_numpy(x) for x in paper_batches(coo, dense=True)]
    gen = torch.Generator(DEVICE).manual_seed(19)
    queries = [torch.randn((32, 16), generator=gen, device=DEVICE)
               for _ in range(OBSERVE_WAVES)]
    check(not obs.enabled(), "observe: obs is on before the phase")
    observe_pass(sparse_b, dense_b, queries)             # warm-up, obs off
    passes = []
    for mode in ("off", "on", "on", "off"):
        if mode == "on":
            out, nums, rec = observe_on_pass(sparse_b, dense_b, queries)
        else:
            (out, nums), rec = observe_pass(sparse_b, dense_b, queries), None
        passes.append((mode, out, nums, rec))

    (ref, ref_waves, _), ref_n = passes[0][1], passes[0][2]
    factor = obs.gate.drift_factor()
    for i, (mode, (res, waves, _), nums, rec) in enumerate(passes[1:], 1):
        what = f"observe: pass {i} (obs {mode})"
        for name in ("sparse", "dense"):
            for f in ("u", "s", "v"):
                a, b = getattr(ref[name].state, f), getattr(res[name].state, f)
                check(torch.equal(a, b), f"{what}: {name} {f} differs by "
                      f"{max_err(a, b)}")
        for j, (a, b) in enumerate(zip(ref_waves, waves)):
            check(torch.equal(a.scores, b.scores)
                  and torch.equal(a.indices, b.indices),
                  f"{what}: wave {j} differs")
        for key in ("dispatch", "trace_count", "launches",
                    "host_syncs_per_batch"):
            check(ref_n[key] == nums[key], f"{what}: {key} {nums[key]}, "
                  f"with obs off {ref_n[key]}")
        if rec is None:
            continue
        for rule in ("R5", "R6", "R7"):
            keys = [k for k in rec["ratios"] if k.split("/")[0] == rule]
            check(keys, f"{what}: no {rule} drift recorded {rec['ratios']}")
            for k in keys:
                check(rec["ratios"][k] <= factor, f"{what}: drift {k} = "
                      f"{rec['ratios'][k]} > {factor}")
        spans_x = [e for e in rec["events"] if e.ph == "X"]
        check(spans_x and all(np.isfinite(e.dur_us) and e.dur_us >= 0
                              for e in spans_x),
              f"{what}: a span's duration is unresolved or negative")
        rec["top_us"] = sum(e.dur_us for e in spans_x if e.depth == 0)
        rec["wall_us"] = (nums["sparse_wall_s"] + nums["dense_wall_s"]
                          + nums["waves_wall_s"]) * 1e6
        check(rec["top_us"] <= rec["wall_us"], f"{what}: top-level spans "
              f"{rec['top_us']} us > wall {rec['wall_us']} us")
        d = rec["diag"]
        check(d.span_summary is not None and d.drift_ratios is not None,
              f"{what}: Diagnostics lacks the obs digests")
        check(rec["metrics"]["serve_requests_total"] == OBSERVE_WAVES,
              f"{what}: serve_requests_total "
              f"{rec['metrics']['serve_requests_total']}")
    for kernel, want in (("sparse_gram", len(sparse_b)),
                         ("blockgram", len(dense_b)),
                         ("topk_score", OBSERVE_WAVES)):
        check(ref_n["launches"][kernel] == want, f"observe: {kernel} "
              f"launched {ref_n['launches'][kernel]} times, want {want}")
    ab = obs_off_ab(passes[-1][1][2], queries)
    state["observe_sync_sites"] = sorted({
        site for _, _, n, _ in passes
        for sites in n["sync_sites"].values() for site in sites})
    ms = {mode: {k: [n["ms_per_batch"][k] for m, _, n, _ in passes
                     if m == mode] for k in ("sparse", "dense", "wave")}
          for mode in ("off", "on")}
    on = [r for _, _, _, r in passes if r is not None]
    emit("observe", batches=dict(sparse=len(sparse_b), dense=len(dense_b),
                                 waves=OBSERVE_WAVES),
         passes=[m for m, _, _, _ in passes], results_equal=True,
         drift_ratios=[r["ratios"] for r in on], drift_factor=factor,
         ms_per_batch=ms,
         ms_per_batch_median={mode: {k: float(np.median(v))
                                     for k, v in ms[mode].items()}
                              for mode in ms},
         host_syncs_per_batch=ref_n["host_syncs_per_batch"],
         sync_sites=dict(off=ref_n["sync_sites"],
                         on=passes[1][2]["sync_sites"]),
         dispatch=ref_n["dispatch"], trace_count=ref_n["trace_count"],
         launches=ref_n["launches"],
         spans=[sum(e.ph == "X" for e in r["events"]) for r in on],
         top_level_span_ms=[r["top_us"] / 1e3 for r in on],
         wall_ms=[r["wall_us"] / 1e3 for r in on],
         trace_events=[len(r["chrome"]["traceEvents"]) for r in on],
         span_summary_ms={name: [count, us / 1e3] for name, count, us
                          in obs.span_summary(on[0]["events"])},
         serve_metrics={k: v for k, v in on[0]["metrics"].items()
                        if k.startswith("serve_")},
         obs_off_gate=ab,
         clocks="ms_per_batch: host clock around each svd_stream / the "
                "waves, device synchronized at both ends, one value a "
                "pass (after an obs-off warm-up pass, off, on, on, off); "
                "spans: device time between CUDA events")


def classify_sync_sites(sites) -> dict:
    """Each "file:line" host-sync site against RL107 (``repro_torch.
    analysis``): ``outside`` the port's package; ``covered``: the line
    lies in a call RL107 flags (suppressed or not); ``out_of_reach``: a
    module outside serve/ and stream/, or a line lexically in no host
    loop (reached through a call: RL107 follows none); ``missed``: in a
    loop body of a serve/ or stream/ module and not flagged."""
    import ast
    from repro_torch.analysis import get_rule
    from repro_torch.analysis.regions import ProjectContext, build_module
    from repro_torch.analysis.rules import hot_loop_nodes, in_hot_path

    def lines(node):
        return range(node.lineno, node.end_lineno + 1)

    rule = get_rule("RL107")
    reach = {}
    out = dict(outside=[], covered=[], out_of_reach=[], missed=[])
    for site in sites:
        path, line = site.rsplit(":", 1)
        line = int(line)
        if not path.startswith("src/repro_torch/"):
            out["outside"].append(site)
            continue
        if path not in reach:
            with open(os.path.join(ROOT, path)) as f:
                m = build_module(path, f.read())
            calls = {(n.lineno, n.col_offset + 1): n for n in ast.walk(m.tree)
                     if isinstance(n, ast.Call)}
            flagged = {ln for fnd in rule.check(m, ProjectContext([m]))
                       for ln in lines(calls[(fnd.line, fnd.col)])}
            looped = {ln for _, n in hot_loop_nodes(m)
                      if not isinstance(n, (ast.FunctionDef, ast.Lambda))
                      and hasattr(n, "lineno") for ln in lines(n)}
            reach[path] = (in_hot_path(m), flagged, looped)
        hot, flagged, looped = reach[path]
        if not hot:
            out["out_of_reach"].append(f"{site} (not serve/ or stream/)")
        elif line in flagged:
            out["covered"].append(site)
        elif line in looped:
            out["missed"].append(site)
        else:
            out["out_of_reach"].append(f"{site} (in no host loop)")
    return out


def phase_lint(state) -> None:
    """The analyzer (``repro_torch.analysis``) over the port's package:
    no unsuppressed finding; then every host-sync site phase ``observe``
    recorded on the card, classified against RL107 (``classify_sync_
    sites``): a site in a hot-path loop that RL107 does not flag fails."""
    from repro_torch.analysis import analyze_paths

    t0 = time.perf_counter()
    result = analyze_paths([os.path.join(ROOT, "src", "repro_torch")])
    secs = time.perf_counter() - t0
    check(not result.errors, f"lint: analysis errors {result.errors}")
    check(not result.findings, "lint: unsuppressed findings:\n" + "\n".join(
        f.render() for f in result.findings))
    sites = state["observe_sync_sites"]
    classes = classify_sync_sites(sites)
    check(not classes["missed"], f"lint: host syncs the card recorded in "
          f"hot-path loops that RL107 does not flag: {classes['missed']}")
    emit("lint", files=result.files_analyzed, findings=0, seconds=secs,
         sync_sites=len(sites),
         counts={k: len(v) for k, v in classes.items()}, sites=classes)


# Phase ``trace``: ``scripts/ranky_trace_torch.py`` as the reference's CI
# runs its twin (the defaults, Prometheus text), then at the paper's column
# count (JSON metrics).
TRACE_RUNS = (
    ("ci", (), "metrics.prom"),
    ("paper", ("--n", "170897", "--rows", "64", "--rank", "16",
               "--batches", "24", "--waves", "32"), "metrics.json"),
)
TRACE_CATEGORIES = {"ingest", "merge", "serve", "snapshot"}
# What the reference's ``scripts/ranky_trace.py`` wrote (``--batches 4
# --waves 4 --n 256`` on the CPU): its span and instant-event names and its
# metric names (Prometheus text; the JSON export has no _sum / _count).
TRACE_REFERENCE_SPANS = {"ingest.batch", "ingest.window", "merge.svd",
                         "serve.topk", "snapshot.stage", "snapshot.publish"}
TRACE_REFERENCE_METRICS = {
    "drift_estimated_bytes", "drift_measured_bytes", "drift_ratio",
    "ingest_batches_total", "ingest_rows_total", "jit_cache_size",
    "planner_plans_total", "serve_latency_us", "serve_latency_us_count",
    "serve_latency_us_sum", "serve_queries_total", "serve_requests_total",
    "snapshot_age_seconds", "snapshot_version", "window_compile_total",
    "window_dispatch_total"}
PROM_LINE = r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})? (\S+)$"


def metric_names(path: str) -> set:
    """The metric names of a metrics export: Prometheus text (every line
    that is not a comment is ``name{labels} value``) or JSON."""
    import re

    with open(path) as f:
        if path.endswith(".json"):
            doc = json.load(f)
            return {key.split("{", 1)[0] for kind in doc.values()
                    for key in kind}
        names = set()
        for line in f.read().splitlines():
            if not line or line.startswith("#"):
                continue
            m = re.match(PROM_LINE, line)
            check(m is not None, f"trace: {path}: bad line {line!r}")
            float(m.group(3))
            names.add(m.group(1))
        return names


def phase_trace(state) -> None:
    """``scripts/ranky_trace_torch.py`` as a process on the card, at the
    reference CI's invocation and at the paper's column count: a valid
    trace covering the reference's categories and span names, metrics that
    parse and hold the reference's names, ``blockgram`` launched by the
    stream and ``topk_score`` exactly once a wave, drift within the
    factor and no ``DriftWarning``."""
    import tempfile

    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    factor = obs.gate.drift_factor()
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        for name, args, metrics in TRACE_RUNS:
            out = os.path.join(tmp, f"{name}.trace.json")
            mpath = os.path.join(tmp, f"{name}.{metrics}")
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable,
                 os.path.join(ROOT, "scripts", "ranky_trace_torch.py"),
                 out, "--metrics", mpath, *args],
                env=env, capture_output=True, text=True, timeout=600)
            wall = time.perf_counter() - t0
            what = f"trace[{name}]"
            check(proc.returncode == 0, f"{what}: exited {proc.returncode}"
                  f":\n{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
            last = proc.stdout.strip().splitlines()[-1]
            check(last.startswith("summary "), f"{what}: no summary line")
            summary = json.loads(last[len("summary "):])
            with open(out) as f:
                doc = json.load(f)
            obs.validate_chrome_trace(doc)
            events = doc["traceEvents"]
            cats = {e["name"].split(".", 1)[0] for e in events
                    if e["ph"] == "X"}
            names = {e["name"] for e in events if e["ph"] in ("X", "i")}
            check(TRACE_CATEGORIES <= cats, f"{what}: span categories "
                  f"{sorted(cats)} lack {sorted(TRACE_CATEGORIES - cats)}")
            check(TRACE_REFERENCE_SPANS <= names, f"{what}: lacks the "
                  f"reference's {sorted(TRACE_REFERENCE_SPANS - names)}")
            got = metric_names(mpath)
            want = TRACE_REFERENCE_METRICS
            if metrics.endswith(".json"):
                want = {n for n in want if not n.endswith(("_sum", "_count"))}
            check(want <= got, f"{what}: metrics lack {sorted(want - got)}")
            launches = summary["launches"]
            check(summary["stream_launches"]["blockgram"] >= 1,
                  f"{what}: the stream never launched blockgram")
            check(summary["serve_launches"]["topk_score"] == summary["waves"]
                  and launches["topk_score"] == summary["waves"],
                  f"{what}: topk_score launched {launches['topk_score']} "
                  f"times for {summary['waves']} waves")
            drift = summary["drift"]
            for rule in ("R5", "R6", "R7"):
                check(any(k.split("/")[0] == rule for k in drift),
                      f"{what}: no {rule} drift recorded {drift}")
            check("DriftWarning" not in proc.stderr
                  and all(r <= factor for r in drift.values()),
                  f"{what}: drift {drift} (limit {factor})")
            runs.append(dict(
                run=name, args=list(args), wall_s=wall,
                stream_s=summary["stream_s"], serve_s=summary["serve_s"],
                trace_events=summary["trace_events"], spans=sum(
                    e["ph"] == "X" for e in events),
                instants=sum(e["ph"] == "i" for e in events),
                span_categories=sorted(cats), metric_names=len(got),
                launches=launches, drift=drift))
            keep_counts(state, f"trace[{name}]", launches)
    emit("trace", runs=runs, drift_factor=factor,
         clocks="wall_s: the process, interpreter start and the kernel "
                "library's load included; stream_s / serve_s: its host "
                "clock, the device synchronized at the end")


def load_script(name):
    """A module of ``scripts/`` by file (the folder is not a package)."""
    import importlib.util

    root = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(root, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod            # its dataclasses look it up
    spec.loader.exec_module(mod)
    return mod


def phase_drift_stages(state) -> None:
    """Where the streaming example's first ingest and window spend their
    peak bytes, stage by stage, beside the R5 / R6 terms
    (``scripts/drift_stages_torch.py``)."""
    mod = load_script("drift_stages_torch")
    torch.cuda.empty_cache()
    out = mod.run(device=DEVICE)
    check(not obs.enabled(), "drift_stages: obs left on")
    emit("drift_stages", **out)


# ---------------------------------------------------------------------------
# Phase: the sharded engine (core/distributed.py, the sharded ingest,
# window and ranker) on a local mesh, on ranks over gloo, and over NCCL
# ---------------------------------------------------------------------------

DIST_RANKS = 4
DIST_TIMEOUT_S = 240

# One rank of part (b) / (c): ``python -c`` with rank, world, backend, the
# init file and the output path as arguments.
DIST_RANK_BODY = r"""
import datetime, json, os, sys, time
import numpy as np
import torch
import torch.distributed as dist
rank, world, backend, init, out_path = (int(sys.argv[1]), int(sys.argv[2]),
                                        sys.argv[3], sys.argv[4], sys.argv[5])
device = torch.device("cuda", rank % torch.cuda.device_count())
torch.cuda.set_device(device)
dist.init_process_group(backend, init_method="file://" + init, rank=rank,
                        world_size=world,
                        timeout=datetime.timedelta(seconds=120))
from repro_torch import obs
from repro_torch.configs.ranky_paper import RankyPaperConfig
from repro_torch.core import api
from repro_torch.core.collectives import ProcessGroupMesh
from repro_torch.data import bipartite
from repro_torch.kernels import launch_counts
from repro_torch.stream import state as stream_state
coo = bipartite.paper_coo(RankyPaperConfig())
mesh = ProcessGroupMesh(world, device=device)
cfg = api.SolveConfig(backend="shard_map", method="neighbor_random",
                      use_kernel=True)
api.svd(coo, cfg, mesh=mesh)
torch.cuda.synchronize()
t0 = time.perf_counter()
res = api.svd(coo, cfg, mesh=mesh)
solve_ms = (time.perf_counter() - t0) * 1e3
stream_state.set_stream_devices(mesh)
scfg = api.SolveConfig(method="neighbor_random", truncate_rank=16,
                       oversample=8, num_blocks=world, use_kernel=True,
                       stream_backend="shard_map")
rows = 64
def batch(b):
    sel = (coo.rows >= rows * b) & (coo.rows < rows * (b + 1))
    from repro_torch.core import sparse
    return sparse.COOMatrix(rows=(coo.rows[sel] - rows * b).astype(np.int32),
                            cols=coo.cols[sel], vals=coo.vals[sel],
                            shape=(rows, coo.shape[1]))
st = api.svd_init(coo.shape[1], scfg, device=device)
st = api.svd_update(st, batch(0), scfg).state          # warm: rank grows
obs.enable()
r = api.svd_update(st, batch(1), scfg)
torch.cuda.synchronize()
label = {"rule": "R5d", "site": "shard_map"}
reg = obs.registry()
out = dict(rank=rank, world=world, backend=backend, device=str(device),
           s=res.s.cpu().tolist(), solve_ms=solve_ms,
           ingest_backend=r.plan.backend, drift=obs.drift_ratios(),
           r5d_measured_bytes=reg.gauge_value("drift_measured_bytes", label),
           r5d_estimated_bytes=reg.gauge_value("drift_estimated_bytes",
                                               label),
           ingest_s=r.s.cpu().tolist(), launches=launch_counts(),
           collectives=dict(mesh.counts))
obs.disable()
stream_state.set_stream_devices(None)
with open(out_path, "w") as f:
    json.dump(out, f)
dist.barrier()
dist.destroy_process_group()
"""


def spawn_ranks(world: int, backend: str, tmp: str) -> list:
    """``world`` processes of :data:`DIST_RANK_BODY`, joined with a deadline
    (every rank is killed when it passes): each rank's JSON."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    init = os.path.join(tmp, f"init_{backend}")
    outs = [os.path.join(tmp, f"{backend}_rank{r}.json") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", DIST_RANK_BODY, str(r), str(world), backend,
         init, outs[r]], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]
    deadline = time.monotonic() + DIST_TIMEOUT_S
    logs = []
    try:
        for p in procs:
            try:
                logs.append(p.communicate(
                    timeout=max(1.0, deadline - time.monotonic())))
            except subprocess.TimeoutExpired:
                raise SmokeFailure(f"distributed: the {backend} ranks did "
                                   f"not finish within {DIST_TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        check(p.returncode == 0 and os.path.exists(outs[r]),
              f"distributed: {backend} rank {r} exited {p.returncode}:\n"
              f"{logs[r][1][-3000:]}")
    results = []
    for path in outs:
        with open(path) as f:
            results.append(json.load(f))
    return results


def dist_solves(state, mesh, mesh2, dense) -> list:
    """(a): the one-shot solves on the local mesh, each against the single
    engine with the same seed and against float64."""
    coo = state["coo"]
    rows = []
    cases = (("gram", coo, {}),
             ("proxy", coo, dict(merge_mode="proxy")),
             ("two_level", coo, dict(merge_mode="proxy", two_level=True)),
             ("rank16", coo, dict(method="random", rank=16, oversample=48,
                                  power_iters=4, want_right=True)),
             ("right", coo, dict(want_right=True)),
             ("dense", dense, dict(want_right=True)))
    for name, a, kw in cases:
        base = dict(dict(method="neighbor_random", use_kernel=True), **kw)
        cfg = api.SolveConfig(backend="shard_map", **base)
        on = mesh2 if kw.get("two_level") else mesh
        api.svd(a, cfg, mesh=on)                                # warm
        res, counts = timed_svd(a, cfg, mesh=on)
        keep_counts(state, f"distributed[{name}]", counts)
        single_kw = {k: v for k, v in base.items() if k != "two_level"}
        scfg = api.SolveConfig(backend="single", num_blocks=NUM_BLOCKS,
                               **single_kw)
        api.svd(a, scfg, device=DEVICE)                         # warm
        sres, _ = timed_svd(a, scfg, device=DEVICE)
        what = f"distributed[{name}]"
        check(res.plan.backend == "shard_map", f"{what}: backend "
              f"{res.plan.backend}")
        ds_single = float((res.s.double() - sres.s.double()).abs().max()
                          / sres.s.double()[0])
        # The same computation up to the order of the sums across blocks:
        # 1e-5 of S[0].  The two-level merge is another merge tree than the
        # single engine's flat one (an SVD of SVDs, one rounding more):
        # 1e-4 of S[0] there, and float64 below holds both.
        limit = 1e-4 if kw.get("two_level") else 1e-5
        check(ds_single <= limit, f"{what}: S differs from the single "
              f"engine by {ds_single} of S[0] (limit {limit})")
        if kw.get("rank"):
            want = {"sketch_panel": 1 + cfg.power_iters}
            s_ref = reference_svals(state["sparse_random_repair"],
                                    NUM_BLOCKS).cpu().numpy()
            fields = check_topk(what, res.s, s_ref, 16)
            ortho = float((res.u.T @ res.u - torch.eye(16, device=DEVICE))
                          .abs().max())
            check(ortho <= 1e-4, f"{what}: |U^T U - I|_max {ortho}")
        else:
            want = ({"blockgram": 1} if a is dense else {"sparse_gram": 1})
            a_norm = api.as_block_input(a, NUM_BLOCKS, device=DEVICE)
            repaired = ranky.split_and_repair(a_norm, NUM_BLOCKS, cfg.method,
                                              cfg.resolved_key())
            fields = check_exact_result(what, res, repaired, NUM_BLOCKS,
                                        recon=res.v is not None)
            del a_norm, repaired
        if res.v is not None:
            # V = A^T U / S of the gram path is as orthogonal as the small
            # singular values allow, on either engine: held to the single
            # engine's own, beside the reconstruction above.
            def vortho_of(v):
                k = v.shape[1]
                return float((v.T @ v - torch.eye(k, device=DEVICE))
                             .abs().max())
            vortho, vortho_single = vortho_of(res.v), vortho_of(sres.v)
            fields.update(v_ortho_err=vortho,
                          v_ortho_err_single=vortho_single)
            check(vortho <= vortho_single + 1e-5, f"{what}: |V^T V - I|_max "
                  f"{vortho}, the single engine's {vortho_single}")
        for kernel, n in want.items():
            check(counts[kernel] == n, f"{what}: {kernel} launched "
                  f"{counts[kernel]} times, want {n} (once over the D-stack)")
        rows.append(dict(solve=name, mesh=on.shape,
                         ms=res.diagnostics.wall_time_s * 1e3,
                         single_ms=sres.diagnostics.wall_time_s * 1e3,
                         dS_vs_single=ds_single, dS_vs_single_limit=limit,
                         launches=counts, **fields))
    return rows


def dist_streams(state, mesh, dense_b) -> tuple:
    """(a): the R5d ingest and the sharded window over the paper rows on
    the local mesh, windows against ``window=1`` bit for bit, beside the
    single engine; then 20 sharded waves against the single-device
    ranker."""
    cfg = api.SolveConfig(stream_backend="shard_map", **OBSERVE_CFG)
    scfg = dataclasses.replace(cfg, stream_backend="single")
    rows, states = [], {}
    stream_state.set_stream_devices(mesh)
    try:
        for name, batches in (("sparse", paper_batches(state["coo"])),
                              ("dense", dense_b)):
            api.svd_stream(iter(batches), cfg, device=DEVICE)   # warm
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res, sites = sync_sites(lambda: api.svd_stream(
                iter(batches), cfg, device=DEVICE))
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            counts = read_counts()
            keep_counts(state, f"distributed[stream {name}]", counts)
            loop = api.svd_stream(iter(batches),
                                  dataclasses.replace(cfg, window=1),
                                  device=DEVICE)
            what = f"distributed[stream {name}]"
            check(res.plan.backend == "shard_map", f"{what}: backend "
                  f"{res.plan.backend}")
            for f in ("u", "s", "v"):
                check(torch.equal(getattr(res.state, f),
                                  getattr(loop.state, f)),
                      f"{what}: windows differ from window=1 in {f}")
            kernel = "sparse_gram" if name == "sparse" else "blockgram"
            check(counts[kernel] == len(batches), f"{what}: {kernel} "
                  f"launched {counts[kernel]} times for {len(batches)} "
                  f"batches")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            single = api.svd_stream(iter(batches), scfg, device=DEVICE)
            torch.cuda.synchronize()
            single_secs = time.perf_counter() - t0
            ds = float((res.s.double() - single.s.double()).abs().max()
                       / single.s.double()[0])
            check(ds <= 1e-3, f"{what}: S differs from the single stream by "
                  f"{ds} of S[0]")
            states[name] = res.state
            rows.append(dict(stream=name, batches=len(batches),
                             ms_per_batch=secs / len(batches) * 1e3,
                             single_ms_per_batch=single_secs
                             / len(batches) * 1e3,
                             host_syncs_per_batch=sum(sites.values())
                             / len(batches),
                             dS_vs_single=ds, launches=counts,
                             counters=[res.state.lonely_rows_seen,
                                       res.state.repaired_rows_seen]))
        gen = torch.Generator(DEVICE).manual_seed(20)
        queries = [torch.randn((32, 16), generator=gen, device=DEVICE)
                   for _ in range(OBSERVE_WAVES)]
        serve = api.ServeTopKConfig(batch_size=32, k_top=10)
        sharded = api.serve_init(states["sparse"], serve)
        check(sharded.plan.backend == "shard_map", "distributed: the serve "
              f"plan is {sharded.plan.backend}")
        single_h = api.serve_init(stream_state.gather_state(
            states["sparse"]), dataclasses.replace(serve,
                                                   serve_backend="single"))
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        waves = [api.serve_topk(sharded, q) for q in queries]
        torch.cuda.synchronize()
        wave_secs = time.perf_counter() - t0
        counts = read_counts()
        keep_counts(state, "distributed[waves]", counts)
        check(counts["topk_score"] == OBSERVE_WAVES * NUM_BLOCKS,
              f"distributed: topk_score launched {counts['topk_score']} "
              f"times for {OBSERVE_WAVES} waves of {NUM_BLOCKS} slots")
        for j, (q, w) in enumerate(zip(queries, waves)):
            want = api.serve_topk(single_h, q)
            check(torch.equal(w.scores, want.scores)
                  and torch.equal(w.indices, want.indices),
                  f"distributed: sharded wave {j} differs from the "
                  f"single-device ranker")
        rows.append(dict(waves=OBSERVE_WAVES, batch=32,
                         ms_per_wave=wave_secs / OBSERVE_WAVES * 1e3,
                         launches=counts, equal_to_single=True))

        # Drift, obs on: R5d / R6 / R7 against D times the per-device
        # forms (the card holds every slot's working set), label "local".
        obs.enable()
        obs.reset()
        try:
            for batches in (paper_batches(state["coo"]), dense_b):
                api.svd_stream(iter(batches), cfg, device=DEVICE)
            for q in queries[:2]:
                api.serve_topk(sharded, q)
            drift = obs.drift_ratios()
        finally:
            obs.disable()
            obs.reset()
    finally:
        stream_state.set_stream_devices(None)
    return rows, drift


def phase_distributed(state) -> None:
    """The sharded engine: (a) a LocalMesh of 8 slots on the card (every
    kernel launches once over the D-stack); (b) 4 ranks over gloo on the
    one card, each with its own allocator; (c) NCCL at world =
    ``torch.cuda.device_count()``."""
    import tempfile
    from repro_torch.core.collectives import LocalMesh, ProcessGroupMesh
    from repro_torch.stream.ingest import ingest_shard_map

    t_phase = time.perf_counter()
    coo = state["coo"]
    dense = coo.todense()
    mesh = LocalMesh({"blocks": NUM_BLOCKS}, DEVICE)
    mesh2 = LocalMesh({"pod": 2, "model": 4}, DEVICE)
    solves = dist_solves(state, mesh, mesh2, dense)
    dense_b = [torch.from_numpy(x) for x in paper_batches(coo, dense=True)]
    streams, drift = dist_streams(state, mesh, dense_b)
    del dense

    # (b) 4 gloo ranks on the one card, held against a local mesh of 4.
    cfg4 = api.SolveConfig(backend="shard_map", method="neighbor_random",
                           use_kernel=True)
    local4 = api.svd(coo, cfg4, mesh=LocalMesh(DIST_RANKS, DEVICE))
    factor = obs.gate.drift_factor()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ranks = spawn_ranks(DIST_RANKS, "gloo", tmp)
        gloo_s = time.perf_counter() - t0
    s4 = local4.s.double().cpu()
    for r in ranks:
        what = f"distributed[gloo rank {r['rank']}]"
        ds = float((torch.tensor(r["s"], dtype=torch.float64) - s4).abs()
                   .max() / s4[0])
        check(ds <= 1e-5, f"{what}: S differs from the local mesh of "
              f"{DIST_RANKS} by {ds} of S[0]")
        check(r["ingest_backend"] == "shard_map", f"{what}: ingest backend "
              f"{r['ingest_backend']}")
        ratio = r["drift"].get("R5d/shard_map")
        check(ratio is not None and ratio <= factor, f"{what}: R5d drift "
              f"{ratio} (limit {factor})")
        check(r["launches"]["sparse_gram"] >= 2, f"{what}: sparse_gram "
              f"launched {r['launches']['sparse_gram']} times")

    # (c) NCCL at world = the visible cards: on one card, world 1 in this
    # process, a real communicator whose collectives run on the card.
    world = torch.cuda.device_count()
    nccl = {}
    with tempfile.TemporaryDirectory() as tmp:
        if world == 1:
            import datetime
            dist = torch.distributed
            dist.init_process_group(
                "nccl", init_method="file://" + os.path.join(tmp, "nccl"),
                rank=0, world_size=1, timeout=datetime.timedelta(seconds=60))
            try:
                pg = ProcessGroupMesh(1, device=DEVICE)
                c1 = api.SolveConfig(backend="shard_map",
                                     method="neighbor_random",
                                     use_kernel=True)
                reset_counts()
                res = api.svd(coo, c1, mesh=pg)
                counts = read_counts()
                keep_counts(state, "distributed[nccl solve]", counts)
                single = api.svd(coo, dataclasses.replace(
                    c1, backend="single", num_blocks=1), device=DEVICE)
                ds = float((res.s.double() - single.s.double()).abs().max()
                           / single.s.double()[0])
                check(ds <= 1e-5, f"distributed[nccl]: S differs from the "
                      f"single engine by {ds}")
                scfg = api.SolveConfig(**dict(OBSERVE_CFG, num_blocks=1))
                st = api.svd_init(coo.shape[1], scfg, device=DEVICE)
                batch = paper_batches(coo)[0]
                plan = api.plan_update(batch, scfg, state=st)
                reset_counts()
                sh, _ = ingest_shard_map(
                    st, batch, scfg, dataclasses.replace(
                        plan, backend="shard_map"), mesh=pg)
                counts_i = read_counts()
                keep_counts(state, "distributed[nccl ingest]", counts_i)
                one = api.svd_update(st, batch, scfg).state
                di = float((sh.s.double() - one.s.double()).abs().max()
                           / one.s.double()[0])
                check(di <= 1e-4, f"distributed[nccl]: the ingest's S "
                      f"differs from the single engine by {di}")
                nccl = dict(world=1, backend=dist.get_backend(),
                            solve_dS=ds, ingest_dS=di,
                            launches=dict(solve=counts, ingest=counts_i),
                            collectives=dict(pg.counts))
            finally:
                dist.destroy_process_group()
        else:
            got = spawn_ranks(world, "nccl", tmp)
            nccl = dict(world=world, backend="nccl",
                        s0=[r["s"][0] for r in got],
                        drift=[r["drift"] for r in got])
    seconds = time.perf_counter() - t_phase
    emit("distributed", solves=solves, streams=streams,
         drift_local=drift, drift_factor=factor,
         gloo=dict(ranks=DIST_RANKS, wall_s=gloo_s,
                   per_rank=[dict(rank=r["rank"], solve_ms=r["solve_ms"],
                                  r5d=r["drift"].get("R5d/shard_map"),
                                  r5d_measured_bytes=r["r5d_measured_bytes"],
                                  r5d_estimated_bytes=r[
                                      "r5d_estimated_bytes"],
                                  launches=r["launches"],
                                  collectives=r["collectives"])
                             for r in ranks]),
         nccl=nccl, seconds=seconds,
         clocks="ms: Diagnostics.wall_time_s (host clock, device "
                "synchronized at both ends), warm; streams: host clock "
                "around svd_stream; r5d: each rank's allocator peak over "
                "the per-device closed form")


# ---------------------------------------------------------------------------
# Phase 16c: the LM model mesh (tensor, expert, data, sequence parallel,
# ZeRO-1) over gloo ranks on the one card, and NCCL at world 1
# ---------------------------------------------------------------------------

# (a) serving, expert-parallel: phi3.5-moe at full width, 2 layers, float32,
# capacity factor 8 (nothing drops), prompts of 128 tokens then 8 greedy
# decode steps; the sampled generate of 4 tokens on the prompts' first 16.
# (b) training, TP x DP x ZeRO-1: zamba2-2.7b at full width, 6 layers (one
# shared-block group), float32, AdamW at the full lr from the first step
# (no warmup), remat dots, 4 x 512 from batch_at.  Held in three parts:
# the first batch's gradients (per leaf max |diff| <= grad_rel x max |g|);
# one ZeRO-1 AdamW update from the drawn state with one device's gradient,
# every element within rtol / atol (each element moves by about lr, 30 x
# atol); the 2 steps' losses within loss_tol, and their params per leaf
# within path_rel x the norm of one device's change.  Adam divides each
# element's gradient by its own RMS, so a gradient near 0 (|g| <~ 1e-6 of
# its leaf's max) moves its element by a share of lr that float32
# rounding decides: the mesh sums in another order, and ~200 of a rank's
# 255 M elements then end the 2 steps up to 6e-5 off, past atol, while
# the leaf's change agrees to ~3e-4 of its norm.
# (c) sequence-sharded decode: zamba2 at 6 layers, one request, a cache of
# 8,192 over data 2; the prompt ends 2 tokens before the slabs' boundary,
# so the 4 steps write 2 positions on each slab.
# Limits: the reference tests' (tests/test_distributed.py: logits rtol /
# atol 1e-3; loss 1e-4, params rtol 2e-4 / atol 1e-5).
LM_MESH = dict(
    serve=dict(arch="phi3.5-moe-42b-a6.6b", layers=2, cf=8.0, batch=4,
               seq=128, decode=8, gen_prompt=16, gen_tokens=4,
               temperature=0.8, rtol=1e-3, atol=1e-3),
    train=dict(arch="zamba2-2.7b", layers=6, batch=4, seq=512, steps=2,
               loss_tol=1e-4, rtol=2e-4, atol=1e-5, moved_atols=10,
               grad_rel=1e-4, path_rel=1e-3,
               launches=dict(flash_attention=2, ssd_scan=12)),
    seq=dict(arch="zamba2-2.7b", layers=6, prompt=4094, max_seq=8192,
             decode=4, rtol=1e-3, atol=1e-3),
    galore=dict(arch="zamba2-2.7b", layers=2, attn_every=2, batch=4,
                seq=512, steps=2, rank=32, update_every=1, rtol=2e-4,
                atol=1e-5, gram_rel=1e-5,
                launches=dict(flash_attention=2, ssd_scan=4)),
    mesh={"data": 2, "model": 2}, ranks=4, seq_ranks=2, timeout_s=300)


def lm_mesh_cfg(case: str):
    c = LM_MESH[case]
    over = dict(num_layers=c["layers"], dtype="float32")
    if "cf" in c:
        over["capacity_factor"] = c["cf"]
    return dataclasses.replace(get_config(c["arch"]), **over)


@contextlib.contextmanager
def routing_rows(log: list, mode: str, part: int, parts: int):
    """``routing_log`` for a data shard: each recorded call's rows cut to
    the ``part``-th of ``parts`` (the shard's tokens; a batch splits over
    data in contiguous rows, b-major in the moe layer's (T, K))."""
    def cut(x):
        n = x.shape[0] // parts
        return x[part * n:(part + 1) * n]

    with routing_log([cut(x).to(DEVICE) for x in log], mode) as flips:
        yield flips


def lm_serve_steps(cfg, params, prompts, tokens, ctx, gather):
    """prefill_forward of ``prompts`` then one decode step a column of
    ``tokens`` (teacher-forced): (logits of each step gathered over the
    vocab (steps, B, Vp), the greedy tokens of each step (steps, B))."""
    from repro_torch.models.transformer import vocab_axes

    v_ax = vocab_axes(cfg, ctx)
    with torch.no_grad():
        lg, cache = transformer.prefill_forward(
            cfg, params, {"tokens": prompts},
            max_seq=prompts.shape[1] + tokens.shape[1], ctx=ctx)
        out = [gather(lg, v_ax)]
        for t in range(tokens.shape[1] - 1):
            lg, cache = transformer.decode_step(
                cfg, params, cache, {"tokens": tokens[:, t:t + 1]}, ctx=ctx)
            out.append(gather(lg, v_ax))
    logits = torch.stack(out)
    return logits, logits[..., :cfg.vocab_size].argmax(-1).to(torch.int32)


def lm_serve_reference(tmp) -> dict:
    """(a) on one device: the teacher-forced steps (greedy tokens fed
    back), the routing of every moe call, the sampled generate; saved for
    the ranks."""
    c, cfg = LM_MESH["serve"], lm_mesh_cfg("serve")
    gen = torch.Generator(DEVICE).manual_seed(61)
    params = schema.init_params(cfg, gen, DEVICE)
    prompts = torch.randint(0, cfg.vocab_size, (c["batch"], c["seq"]),
                            generator=gen, device=DEVICE, dtype=torch.int32)
    with torch.no_grad():
        lg, cache = transformer.prefill_forward(
            cfg, params, {"tokens": prompts},
            max_seq=c["seq"] + c["decode"])
        toks = [lg[:, :cfg.vocab_size].argmax(-1).to(torch.int32)]
        for _ in range(c["decode"] - 1):
            lg, cache = transformer.decode_step(
                cfg, params, cache, {"tokens": toks[-1][:, None]})
            toks.append(lg[:, :cfg.vocab_size].argmax(-1).to(torch.int32))
    tokens = torch.stack(toks, 1)
    log = []
    with routing_log(log, "record"):
        logits, greedy = lm_serve_steps(cfg, params, prompts, tokens,
                                        ShardCtx(), lambda x, ax: x)
    check(torch.equal(greedy.T, tokens), "lm_mesh(a): the teacher-forced "
          "steps' greedy tokens are not the fed-back ones")
    scfg = engine.ServeConfig(max_seq=c["gen_prompt"] + c["gen_tokens"],
                              temperature=c["temperature"], seed=5)
    sampled = engine.generate(cfg, params, prompts[:, :c["gen_prompt"]],
                              scfg, c["gen_tokens"])
    ref = dict(prompts=prompts.cpu(), tokens=tokens.cpu(),
               logits=logits.cpu(), routing=[x.cpu() for x in log],
               sampled=sampled.cpu())
    torch.save(ref, os.path.join(tmp, "serve_ref.pt"))
    return dict(ref, params=params)


def lm_train_steps(cfg, tcfg, dcfg, ctx, mesh, steps: int):
    """``steps`` AdamW steps from a fresh state drawn from a seeded
    generator on the card (every rank draws the whole leaves and keeps its
    blocks): (state, losses, host ms a step, flash / ssd launches a
    step)."""
    gen = torch.Generator(DEVICE).manual_seed(62)
    state = train_step.init_train_state(cfg, tcfg, gen, DEVICE, ctx=ctx)
    step = train_step.make_train_step(cfg, tcfg, ctx)
    losses, ms, launches = [], [], []
    for s in range(steps):
        batch = data_mod.shard_batch(data_mod.batch_at(dcfg, s), DEVICE,
                                     mesh)
        reset_counts()
        (state, m), t = synced_ms(lambda: step(state, batch))
        launches.append({k: v for k, v in read_counts().items()
                         if k in ("flash_attention", "ssd_scan")})
        losses.append(float(m["loss"]))
        ms.append(t)
    return state, losses, ms, launches


def lm_train_setup():
    c, cfg = LM_MESH["train"], lm_mesh_cfg("train")
    # no warmup: each step moves the weights by about lr (3e-4), far past
    # the params' atol (1e-5), so a missed update or ZeRO slice shows
    return (cfg, train_step.TrainConfig(remat="dots", warmup_steps=0),
            data_mod.DataConfig(cfg.vocab_size, c["seq"], c["batch"]))


def lm_first_lr_scale(tcfg, opt):
    return schedule_mod.warmup_cosine(opt["step"], warmup=tcfg.warmup_steps,
                                      total=tcfg.total_steps)


def lm_train_reference(tmp) -> dict:
    """(b) on one device: the first batch's gradients and one AdamW update
    with them from the drawn state (saved for the ranks), then the 2
    steps (their params saved)."""
    cfg, tcfg, dcfg = lm_train_setup()
    c = LM_MESH["train"]
    gen = torch.Generator(DEVICE).manual_seed(62)
    st = train_step.init_train_state(cfg, tcfg, gen, DEVICE)
    batch = data_mod.shard_batch(data_mod.batch_at(dcfg, 0), DEVICE)
    _, _, grads = train_step._grads(cfg, tcfg, st["params"], batch)
    torch.save({p: g.cpu() for p, g in ptree.flatten(grads)},
               os.path.join(tmp, "train_ref_grads.pt"))
    start = [x.clone() for x in ptree.leaves(st["params"])]
    adamw_mod.apply_updates(tcfg.adamw, st["params"], grads, st["opt"],
                            lr_scale=lm_first_lr_scale(tcfg, st["opt"]))
    moved = min(float((x - x0).abs().max()) for x, x0 in zip(
        ptree.leaves(st["params"]), start))
    check(moved > c["moved_atols"] * c["atol"], f"lm_mesh(b): one AdamW "
          f"update moved a leaf by at most {moved}, not past "
          f"{c['moved_atols']} x atol {c['atol']}")
    torch.save({p: x.cpu() for p, x in ptree.flatten(st["params"])},
               os.path.join(tmp, "train_ref_update.pt"))
    del st, grads, batch, start
    free_model()
    state, losses, ms, launches = lm_train_steps(
        cfg, tcfg, dcfg, ShardCtx(), None, c["steps"])
    torch.save({p: x.cpu() for p, x in ptree.flatten(state["params"])},
               os.path.join(tmp, "train_ref.pt"))
    torch.save(dict(losses=losses, least_leaf_move=moved),
               os.path.join(tmp, "train_ref_meta.pt"))
    return dict(state=state, losses=losses, ms=ms, launches=launches,
                least_leaf_move=moved)


def lm_mesh_nccl(state, tmp) -> dict:
    """(d) A ProcessGroupMesh (1, 1) over NCCL in this process, (a) and
    (b) at their sizes against the path without a mesh: the same bits
    (the collectives of a group of one copy their input; the sharded
    layers take their plain arithmetic at axis size 1)."""
    import datetime
    from repro_torch.core.collectives import ProcessGroupMesh

    dist = torch.distributed
    dist.init_process_group(
        "nccl", init_method="file://" + os.path.join(tmp, "nccl_lm"),
        rank=0, world_size=1, timeout=datetime.timedelta(seconds=60))
    out = {}
    try:
        mesh = ProcessGroupMesh({"data": 1, "model": 1}, device=DEVICE)
        ctx = ShardCtx(mesh=mesh)
        # (a) serving
        ref = lm_serve_reference(tmp)
        cfg, c = lm_mesh_cfg("serve"), LM_MESH["serve"]
        gen = torch.Generator(DEVICE).manual_seed(61)
        params = schema.init_params(cfg, gen, DEVICE, ctx=ctx)
        same_params = all(torch.equal(a, b) for a, b in zip(
            ptree.leaves(params), ptree.leaves(ref["params"])))
        del ref["params"]
        reset_counts()
        logits, greedy = lm_serve_steps(
            cfg, params, ref["prompts"].to(DEVICE),
            ref["tokens"].to(DEVICE), ctx,
            lambda x, ax: ctx.all_gather(x, ax, dim=-1))
        counts = read_counts()
        keep_counts(state, "lm_mesh[nccl serve]", counts)
        scfg = engine.ServeConfig(max_seq=c["gen_prompt"] + c["gen_tokens"],
                                  temperature=c["temperature"], seed=5)
        sampled = engine.generate(
            cfg, params, ref["prompts"][:, :c["gen_prompt"]].to(DEVICE),
            scfg, c["gen_tokens"], ctx=ctx)
        out["serve"] = dict(
            params_bit_identical=same_params,
            logits_bit_identical=bool(torch.equal(logits.cpu(),
                                                  ref["logits"])),
            logits_max_abs_diff=float((logits.cpu() - ref["logits"]).abs()
                                      .max()),
            tokens_equal=bool(torch.equal(greedy.T.cpu(), ref["tokens"])),
            sampled_equal=bool(torch.equal(sampled.cpu(), ref["sampled"])),
            launches=counts)
        del params, logits
        free_model()
        # (b) training
        tref = lm_train_reference(tmp)
        cfg, tcfg, dcfg = lm_train_setup()
        st, losses, ms, launches = lm_train_steps(
            cfg, tcfg, dcfg, ctx, mesh, LM_MESH["train"]["steps"])
        keep_counts(state, "lm_mesh[nccl train step]", dict(
            read_counts(), **launches[-1]))
        same = [bool(torch.equal(a, b)) for a, b in zip(
            ptree.leaves(st["params"]), ptree.leaves(tref["state"]["params"]))]
        out["train"] = dict(
            losses=losses, losses_no_mesh=tref["losses"],
            losses_bit_identical=losses == tref["losses"],
            params_bit_identical=all(same),
            leaves_differing=len(same) - sum(same),
            ms_per_step=ms, ms_per_step_no_mesh=tref["ms"],
            launches_per_step=launches[-1],
            launches_per_step_no_mesh=tref["launches"][-1],
            least_leaf_move_one_update_no_mesh=tref["least_leaf_move"])
        for n in launches + tref["launches"]:
            check(n == LM_MESH["train"]["launches"], f"lm_mesh(d) NCCL "
                  f"world 1 train: kernel launches a step {n}, not "
                  f"{LM_MESH['train']['launches']}")
        out["collectives"] = dict(mesh.counts)
        del st, tref
        free_model()
    finally:
        dist.destroy_process_group()
    for case in ("serve", "train"):
        for key, val in out[case].items():
            if key.endswith(("bit_identical", "_equal")):
                check(val, f"lm_mesh(d) NCCL world 1 {case}: {key} is "
                      f"False")
    return out


def spawn_lm_ranks(world: int, case: str, tmp: str) -> list:
    """``world`` processes running :func:`lm_mesh_rank` of ``case`` over a
    gloo group (CUDA tensors on the one card), joined with a deadline
    (every rank is killed when it passes): each rank's saved result."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    code = (f"import sys; sys.path.insert(0, {ROOT!r}); import chip_smoke; "
            f"chip_smoke.lm_mesh_rank()")
    outs = [os.path.join(tmp, f"{case}_rank{r}.pt") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(r), str(world), case, tmp],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    deadline = time.monotonic() + LM_MESH["timeout_s"]
    logs = []
    try:
        for p in procs:
            try:
                logs.append(p.communicate(
                    timeout=max(1.0, deadline - time.monotonic())))
            except subprocess.TimeoutExpired:
                raise SmokeFailure(f"lm_mesh: the {case} ranks did not "
                                   f"finish within {LM_MESH['timeout_s']} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        check(p.returncode == 0 and os.path.exists(outs[r]),
              f"lm_mesh: {case} rank {r} exited {p.returncode}:\n"
              f"{logs[r][1][-3000:]}")
    return [torch.load(path, weights_only=False) for path in outs]


def lm_mesh_rank() -> None:
    """One rank of phase ``lm_mesh`` (a process of :func:`spawn_lm_ranks`):
    argv rank, world, case, the shared directory."""
    import datetime
    from repro_torch.core.collectives import ProcessGroupMesh

    rank, world, case, tmp = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4])
    torch.cuda.set_device(0)
    dist = torch.distributed
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(tmp, f"init_{case}"),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=240))
    try:
        if case == "seq":
            mesh = ProcessGroupMesh({"data": world, "model": 1},
                                    device=DEVICE)
            out = lm_seq_rank(ShardCtx(mesh=mesh))
        elif case == "galore":
            mesh = ProcessGroupMesh(LM_MESH["mesh"], device=DEVICE)
            out = dict(galore=lm_galore_rank(ShardCtx(mesh=mesh), mesh,
                                             tmp))
        else:
            mesh = ProcessGroupMesh(LM_MESH["mesh"], device=DEVICE)
            ctx = ShardCtx(mesh=mesh)
            out = dict(serve=lm_serve_rank(ctx, tmp))
            free_model()
            out["train"] = lm_train_rank(ctx, mesh, tmp)
        out.update(rank=rank, coords=mesh.coords(rank),
                   collectives=dict(mesh.counts))
        torch.save(out, os.path.join(tmp, f"{case}_rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def lm_gap(got, want, rtol, atol) -> dict:
    diff = (got.double() - want.double()).abs()
    excess = float((diff - atol - rtol * want.double().abs()).max())
    return dict(max_abs_diff=float(diff.max()), max_excess=excess,
                within=excess <= 0)


def lm_serve_rank(ctx, tmp) -> dict:
    c, cfg = LM_MESH["serve"], lm_mesh_cfg("serve")
    ref = torch.load(os.path.join(tmp, "serve_ref.pt"), weights_only=False)
    b_ax = ctx.axes("batch")
    part, parts = ctx.index(b_ax), ctx.size(b_ax)
    rows = slice(part * c["batch"] // parts, (part + 1) * c["batch"] // parts)
    gen = torch.Generator(DEVICE).manual_seed(61)
    params = schema.init_params(cfg, gen, DEVICE, ctx=ctx)
    prompts = ref["prompts"][rows].to(DEVICE)
    tokens = ref["tokens"][rows].to(DEVICE)

    def gather(x, ax):
        return ctx.all_gather(x, ax, dim=-1)

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    with routing_rows(ref["routing"], "compare", part, parts) as flips:
        (logits, greedy), ms = synced_ms(lambda: lm_serve_steps(
            cfg, params, prompts, tokens, ctx, gather))
    launches = read_counts()
    want = ref["logits"][:, rows]
    free = lm_gap(logits.cpu(), want, c["rtol"], c["atol"])
    out = dict(rows=[rows.start, rows.stop], ms=ms, launches=launches,
               flipped_routings=int(sum(flips)), free=free,
               tokens_equal=bool(torch.equal(greedy.T.cpu(),
                                             ref["tokens"][rows])),
               peak_bytes=torch.cuda.max_memory_allocated())
    if out["flipped_routings"]:
        with routing_rows(ref["routing"], "pin", part, parts):
            logits, greedy = lm_serve_steps(cfg, params, prompts, tokens,
                                            ctx, gather)
        out["pinned"] = lm_gap(logits.cpu(), want, c["rtol"], c["atol"])
        out["tokens_equal_pinned"] = bool(torch.equal(
            greedy.T.cpu(), ref["tokens"][rows]))
    scfg = engine.ServeConfig(max_seq=c["gen_prompt"] + c["gen_tokens"],
                              temperature=c["temperature"], seed=5)
    sampled = engine.generate(cfg, params, prompts[:, :c["gen_prompt"]],
                              scfg, c["gen_tokens"], ctx=ctx)
    out["sampled"] = sampled.cpu()
    out["sampled_equal"] = bool(torch.equal(sampled.cpu(),
                                            ref["sampled"][rows]))
    out["greedy"] = greedy.T.cpu()
    return out


def lm_excess(x, ref, c) -> torch.Tensor:
    """Each element's |x - ref| past atol + rtol |ref| (<= 0: within)."""
    return (x - ref).abs() - c["atol"] - c["rtol"] * ref.abs()


def lm_train_rank(ctx, mesh, tmp) -> dict:
    """(b) on one of the 4 ranks (see ``LM_MESH``): the first batch's
    gradients, psummed over data, against one device's; one ZeRO-1 AdamW
    update with one device's gradients against one device's update; the
    2 steps against one device's."""
    c = LM_MESH["train"]
    cfg, tcfg, dcfg = lm_train_setup()
    specs = [sp for _, sp in ptree.flatten(schema.param_specs(cfg, ctx),
                                           dicts_only=True)]

    def load(name):
        return torch.load(os.path.join(tmp, name), mmap=True,
                          weights_only=True)

    gen = torch.Generator(DEVICE).manual_seed(62)
    st = train_step.init_train_state(cfg, tcfg, gen, DEVICE, ctx=ctx)
    start = {p: x.clone() for p, x in ptree.flatten(st["params"])}
    batch = data_mod.shard_batch(data_mod.batch_at(dcfg, 0), DEVICE, mesh)
    _, _, grads = train_step._grads(cfg, tcfg, st["params"], batch, ctx)
    grads = train_step._psum_tree(grads, ctx, ctx.axes("batch"))
    zero, grad_rel, grad_leaf = [], 0.0, None
    want = load("train_ref_grads.pt")
    mine = []
    for (path, g), sp in zip(ptree.flatten(grads), specs):
        if float(g.abs().max()) == 0.0:
            zero.append(path)
        ref = ctx.local(want[path], sp).to(DEVICE)
        rel = float((g - ref).abs().max()) / max(
            float(want[path].abs().max()), 1e-30)
        if rel > grad_rel:
            grad_rel, grad_leaf = rel, path
        mine.append(ref)
    del grads, batch, want
    # one ZeRO-1 update with one device's gradients
    sh = train_step.state_shardings(cfg, tcfg, ctx)
    adamw_mod.apply_updates(
        tcfg.adamw, st["params"], ptree.unflatten(st["params"], mine),
        st["opt"], lr_scale=lm_first_lr_scale(tcfg, st["opt"]), ctx=ctx,
        specs=sh["params"], mspecs=sh["opt"]["m"])
    del mine
    want = load("train_ref_update.pt")
    update_excess, update_leaf = -float("inf"), None
    for (path, x), sp in zip(ptree.flatten(st["params"]), specs):
        ref = ctx.local(want[path], sp).to(DEVICE)
        excess = float(lm_excess(x, ref, c).max())
        if excess > update_excess:
            update_excess, update_leaf = excess, path
    del st, want
    free_model()
    # the 2 steps
    torch.cuda.reset_peak_memory_stats()
    state, losses, ms, launches = lm_train_steps(cfg, tcfg, dcfg, ctx, mesh,
                                                 c["steps"])
    peak = torch.cuda.max_memory_allocated()
    want = load("train_ref.pt")
    path_rel, path_leaf, over, elements = 0.0, None, 0, 0
    for (path, x), sp in zip(ptree.flatten(state["params"]), specs):
        ref = ctx.local(want[path], sp).to(DEVICE)
        rel = float((x - ref).norm() / (ref - start[path]).norm().clamp_min(
            1e-30))
        if rel > path_rel:
            path_rel, path_leaf = rel, path
        over += int((lm_excess(x, ref, c) > 0).sum())
        elements += x.numel()
    return dict(losses=losses, ms_per_step=ms, launches_per_step=launches,
                peak_bytes=peak, leaves_without_gradient=zero,
                grad_max_rel=grad_rel, grad_worst_leaf=grad_leaf,
                update_max_excess=update_excess,
                update_worst_leaf=update_leaf,
                path_max_rel=path_rel, path_worst_leaf=path_leaf,
                path_elements_past_rtol_atol=over, path_elements=elements,
                local_param_count=schema.param_count_actual(state["params"]))


def lm_seq_rank(ctx) -> dict:
    """(c) on one of two ranks: the prompt prefilled on one device's
    layout (every rank the same), its cache cut to this rank's slab of
    positions, then the decode steps sharded against the unsharded
    ones."""
    c, cfg = LM_MESH["seq"], lm_mesh_cfg("seq")
    gen = torch.Generator(DEVICE).manual_seed(63)
    params = schema.init_params(cfg, gen, DEVICE)
    toks = torch.randint(0, cfg.vocab_size, (1, c["prompt"] + c["decode"]),
                         generator=gen, device=DEVICE, dtype=torch.int32)
    with torch.no_grad():
        reset_counts()
        _, cache = transformer.prefill_forward(
            cfg, params, {"tokens": toks[:, :c["prompt"]]},
            max_seq=c["max_seq"])
        prefill_launches = read_counts()
        mine = transformer.local_cache(cfg, cache, ctx, seq_sharded=True)
        slab = mine["k"].shape[3]
        lo = ctx.index(ctx.axes("seq_shard")) * slab
        want, got, changed, ms = [], [], [], []
        for t in range(c["prompt"], c["prompt"] + c["decode"]):
            step = {"tokens": toks[:, t:t + 1]}
            lg, cache = transformer.decode_step(cfg, params, cache, step)
            want.append(lg.cpu())
            before = mine["k"].clone()
            (lg, mine), t_ms = synced_ms(lambda: transformer.decode_step(
                cfg, params, mine, step, ctx=ctx, seq_sharded=True))
            ms.append(t_ms)
            got.append(lg.cpu())
            diff = (mine["k"] != before).any(dim=(0, 1, 2, 4))
            changed.append(diff.nonzero()[:, 0].add(lo).tolist())
    gap = lm_gap(torch.stack(got), torch.stack(want), c["rtol"], c["atol"])
    owned = [[t] if lo <= t < lo + slab else []
             for t in range(c["prompt"], c["prompt"] + c["decode"])]
    return dict(gap=gap, slab=[lo, lo + slab], changed=changed,
                owned=owned, writes_owned_only=changed == owned,
                ms_per_step=ms, prefill_launches=prefill_launches)


def lm_galore_setup():
    """(e): zamba2-2.7b at full width cut to 2 layers with the shared
    block opening them (``hybrid_attn_every`` 2, so that every leaf has a
    gradient and flash runs), float32, GaLore at rank 32 refreshed every
    step, no warmup, remat ``dots``."""
    c = LM_MESH["galore"]
    cfg = dataclasses.replace(get_config(c["arch"]), num_layers=c["layers"],
                              hybrid_attn_every=c["attn_every"],
                              dtype="float32")
    tcfg = train_step.TrainConfig(
        optimizer="galore", remat="dots", warmup_steps=0,
        galore=galore_mod.GaloreConfig(rank=c["rank"],
                                       update_every=c["update_every"]))
    return cfg, tcfg, data_mod.DataConfig(cfg.vocab_size, c["seq"],
                                          c["batch"])


def galore_cols(cfg, tcfg, params, seed: int) -> dict:
    """The repair columns that step 0 of ``make_train_step`` draws (its
    seed chain), by path: (m,) over each eligible leaf's global (m, n)."""
    out = {}
    shapes = dict(ptree.flatten(schema.param_shapes(cfg), dicts_only=True))
    for i, (path, _) in enumerate(ptree.flatten(params)):
        shape = shapes[path]
        if galore_mod.eligible(tcfg.galore, shape):
            out[path] = galore_mod.draw_cols(ranky.derive_seed(seed, 0), i,
                                             *shape[-2:])
    return out


def lm_galore_reference(state, tmp) -> dict:
    """(e) on one device: the first batch's gradients and the grams and
    lonely masks of every eligible leaf (saved for the ranks), step 0's
    GaLore update (its bases and parameters saved), step 1 timed; then a
    (1, 1) NCCL mesh's step 0 bit for bit against it."""
    cfg, tcfg, dcfg = lm_galore_setup()
    gen = torch.Generator(DEVICE).manual_seed(64)
    st = train_step.init_train_state(cfg, tcfg, gen, DEVICE)
    batch = data_mod.shard_batch(data_mod.batch_at(dcfg, 0), DEVICE)
    reset_counts()
    _, _, grads = train_step._grads(cfg, tcfg, st["params"], batch)
    launches0 = {k: v for k, v in read_counts().items()
                 if k in ("flash_attention", "ssd_scan")}
    cols = galore_cols(cfg, tcfg, st["params"], st["seed"])
    grams, lonely = {}, {}
    for path, g in ptree.flatten(grads):
        if path in cols:
            gram, mask, _ = galore_mod.mesh_gram(tcfg.galore, g, (),
                                                 ShardCtx(), cols[path])
            grams[path], lonely[path] = gram.cpu(), mask.cpu()
    torch.save(grams, os.path.join(tmp, "galore_grams.pt"))
    torch.save(dict(lonely=lonely, cols=cols),
               os.path.join(tmp, "galore_cols.pt"))
    del grams
    torch.save({p: g.cpu() for p, g in ptree.flatten(grads)},
               os.path.join(tmp, "galore_grads.pt"))
    seed0 = ranky.derive_seed(st["seed"], 0)
    with event_timed({"galore": (galore_mod, "apply_updates")}) as t:
        galore_mod.apply_updates(tcfg.adamw, tcfg.galore, st["params"],
                                 grads, st["opt"],
                                 lr_scale=lm_first_lr_scale(tcfg, st["opt"]),
                                 seed=seed0)
    refresh_ms = t["galore"]["ms"]
    del grads
    bases = {path: galore_mod._leaf_state(st["opt"]["leaves"],
                                          path)["p"].cpu() for path in cols}
    params1 = {p: x.clone() for p, x in ptree.flatten(st["params"])}
    torch.save(bases, os.path.join(tmp, "galore_bases.pt"))
    torch.save({p: x.cpu() for p, x in params1.items()},
               os.path.join(tmp, "galore_params1.pt"))
    step = train_step.make_train_step(cfg, tcfg)
    batch = data_mod.shard_batch(data_mod.batch_at(dcfg, 1), DEVICE)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    (st, _), ms = synced_ms(lambda: step(st, batch))
    launches1 = {k: v for k, v in read_counts().items()
                 if k in ("flash_attention", "ssd_scan")}
    peak = torch.cuda.max_memory_allocated()
    del st
    free_model()
    nccl = lm_galore_nccl(cfg, tcfg, dcfg, params1, tmp)
    del params1
    free_model()
    return dict(launches_a_step=[launches0, launches1], ms_step_1=ms,
                refresh_ms_step_0=refresh_ms, peak_bytes=peak,
                eligible_leaves=len(cols), nccl_1x1=nccl)


def lm_galore_nccl(cfg, tcfg, dcfg, params1, tmp) -> dict:
    """A (1, 1) ``ProcessGroupMesh`` over NCCL: step 0 of
    ``make_train_step`` (the mesh's GaLore path) against one device's."""
    import datetime
    from repro_torch.core.collectives import ProcessGroupMesh

    dist = torch.distributed
    dist.init_process_group(
        "nccl", init_method="file://" + os.path.join(tmp, "nccl_galore"),
        rank=0, world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        mesh = ProcessGroupMesh({"data": 1, "model": 1}, device=DEVICE)
        ctx = ShardCtx(mesh=mesh)
        gen = torch.Generator(DEVICE).manual_seed(64)
        st = train_step.init_train_state(cfg, tcfg, gen, DEVICE, ctx=ctx)
        batch = data_mod.shard_batch(data_mod.batch_at(dcfg, 0), DEVICE,
                                     mesh)
        train_step.make_train_step(cfg, tcfg, ctx)(st, batch)
        same = {p: bool(torch.equal(x, params1[p]))
                for p, x in ptree.flatten(st["params"])}
        del st
    finally:
        dist.destroy_process_group()
    check(all(same.values()), f"lm_mesh(e) NCCL (1, 1): GaLore's step "
          f"differs from one device's in "
          f"{[p for p, ok in same.items() if not ok]}")
    return dict(params_bit_identical=all(same.values()), leaves=len(same))


def lm_galore_rank(ctx, mesh, tmp) -> dict:
    """(e) on one of the 4 ranks: one device's gradients cut to the
    rank's blocks, their grams and masks against one device's, one update
    with one device's bases against one device's; then 2 steps of
    ``make_train_step`` (its own gradients and bases, the bases' digests
    kept), timed, launches and peak."""
    import hashlib

    c = LM_MESH["galore"]
    cfg, tcfg, dcfg = lm_galore_setup()
    gcfg = tcfg.galore
    sh = train_step.state_shardings(cfg, tcfg, ctx)
    specs = dict(ptree.flatten(sh["params"], dicts_only=True))

    def load(name):
        return torch.load(os.path.join(tmp, name), mmap=True,
                          weights_only=True)

    want = load("galore_grads.pt")
    gen = torch.Generator(DEVICE).manual_seed(64)
    st = train_step.init_train_state(cfg, tcfg, gen, DEVICE, ctx=ctx)
    grads = ptree.unflatten(st["params"], [
        ctx.local(want[p], specs[p]).to(DEVICE)
        for p, _ in ptree.flatten(st["params"])])
    del want
    # the grams and masks of one device's gradients
    cl = load("galore_cols.pt")
    one = load("galore_grams.pt")
    gram_rel, gram_leaf, masks_equal = 0.0, None, True
    for path, g in ptree.flatten(grads):
        if path not in cl["cols"]:
            continue
        sp = galore_mod._full(specs[path], g.dim())
        gram, lonely, _ = galore_mod.mesh_gram(gcfg, g, sp, ctx,
                                               cl["cols"][path])
        lead = sp[:-2] + (None, None)
        ref = ctx.local(one[path], lead).to(DEVICE)
        rel = float((gram - ref).abs().max() / ref.abs().max())
        if rel > gram_rel:
            gram_rel, gram_leaf = rel, path
        # an n-side gram's mask covers the rank's row block
        rows = sp[-2] if galore_mod.n_side(*galore_mod.global_shape(
            g.shape, sp, ctx)[-2:]) else None
        masks_equal &= bool(torch.equal(
            lonely.cpu(), ctx.local(cl["lonely"][path], sp[:-2] + (rows,))))
        del gram, ref
    del one
    # one update with one device's bases
    bases = load("galore_bases.pt")
    galore_mod.apply_updates(
        tcfg.adamw, gcfg, st["params"], grads, st["opt"],
        lr_scale=lm_first_lr_scale(tcfg, st["opt"]), bases=bases, ctx=ctx,
        specs=sh["params"])
    del grads, bases
    want = load("galore_params1.pt")
    update_excess, update_leaf = -float("inf"), None
    for path, x in ptree.flatten(st["params"]):
        ref = ctx.local(want[path], specs[path]).to(DEVICE)
        excess = float(lm_excess(x, ref, c).max())
        if excess > update_excess:
            update_excess, update_leaf = excess, path
    del st, want
    free_model()
    # 2 steps of the train step, bases from the whole gradient
    digests = []
    basis = galore_mod.mesh_basis

    def recording(gcfg_, g, spec, ctx_, cols=None):
        out = basis(gcfg_, g, spec, ctx_, cols)
        full = galore_mod._full(spec, g.dim())
        whole = ctx_.gather(out.contiguous(), full[:-2] + (None, None))
        digests.append(hashlib.sha256(
            whole.cpu().numpy().tobytes()).hexdigest())
        return out

    gen = torch.Generator(DEVICE).manual_seed(64)
    st = train_step.init_train_state(cfg, tcfg, gen, DEVICE, ctx=ctx)
    step = train_step.make_train_step(cfg, tcfg, ctx)
    torch.cuda.reset_peak_memory_stats()
    ms, launches, refresh, losses = [], [], [], []
    galore_mod.mesh_basis = recording
    try:
        for s in range(c["steps"]):
            batch = data_mod.shard_batch(data_mod.batch_at(dcfg, s), DEVICE,
                                         mesh)
            reset_counts()
            with event_timed({"galore": (galore_mod, "apply_updates")}) as t:
                (st, m), t_ms = synced_ms(lambda: step(st, batch))
            launches.append({k: v for k, v in read_counts().items()
                             if k in ("flash_attention", "ssd_scan")})
            ms.append(t_ms)
            refresh.append(t["galore"]["ms"])
            losses.append(float(m["loss"]))
    finally:
        galore_mod.mesh_basis = basis
    return dict(gram_max_rel=gram_rel, gram_worst_leaf=gram_leaf,
                lonely_masks_equal=masks_equal,
                update_max_excess=update_excess,
                update_worst_leaf=update_leaf, ms_per_step=ms,
                galore_apply_ms=refresh, launches_per_step=launches,
                losses=losses, peak_bytes=torch.cuda.max_memory_allocated(),
                basis_digests=digests)


def phase_lm_mesh(state) -> None:
    """The LM model mesh: (a) serving and (b) training on 4 gloo ranks
    (data 2 x model 2) on the one card against the single-device port;
    (c) the sequence-sharded decode on 2 ranks; (d) NCCL at world 1 in
    this process, bit for bit against the path without a mesh."""
    import tempfile

    t_phase = time.perf_counter()
    free_model()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        nccl = lm_mesh_nccl(state, tmp)
        emit("lm_mesh", case="(d) NCCL world 1, (1, 1) mesh", **nccl,
             seconds=time.perf_counter() - t0)
        ref_train = torch.load(os.path.join(tmp, "train_ref_meta.pt"))
        t0 = time.perf_counter()
        ranks = spawn_lm_ranks(LM_MESH["ranks"], "ab", tmp)
        ab_s = time.perf_counter() - t0
        ref = torch.load(os.path.join(tmp, "serve_ref.pt"),
                         weights_only=False)
        t0 = time.perf_counter()
        seq = spawn_lm_ranks(LM_MESH["seq_ranks"], "seq", tmp)
        seq_s = time.perf_counter() - t0
        free_model()
        t0 = time.perf_counter()
        galore_one = lm_galore_reference(state, tmp)
        galore_one_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        galore = spawn_lm_ranks(LM_MESH["ranks"], "galore", tmp)
        galore_s = time.perf_counter() - t0

    # (a) serving
    c = LM_MESH["serve"]
    per_rank = []
    for r in ranks:
        s = r["serve"]
        what = f"lm_mesh(a) rank {r['rank']} {r['coords']}"
        held = s.get("pinned", s["free"])
        check(held["within"], f"{what}: logits exceed rtol {c['rtol']}, "
              f"atol {c['atol']} of one device's by {held['max_excess']} "
              f"({'routing pinned' if 'pinned' in s else 'free'})")
        check(s.get("tokens_equal_pinned", s["tokens_equal"]),
              f"{what}: greedy tokens differ from one device's")
        check(s["sampled_equal"], f"{what}: sampled tokens differ from one "
              f"device's rows")
        check(s["launches"]["flash_attention"] == c["layers"],
              f"{what}: flash_attention launched "
              f"{s['launches']['flash_attention']} times")
        per_rank.append(dict(
            rank=r["rank"], coords=r["coords"], rows=s["rows"],
            ms_prefill_and_decode=s["ms"], launches=s["launches"],
            flipped_routings=s["flipped_routings"], free=s["free"],
            pinned=s.get("pinned"), tokens_equal=s["tokens_equal"],
            sampled_equal=s["sampled_equal"], peak_bytes=s["peak_bytes"]))
    by_data = {}
    for r in ranks:
        by_data.setdefault(r["coords"]["data"], []).append(r["serve"])
    for d, group in by_data.items():
        check(all(torch.equal(g["sampled"], group[0]["sampled"])
                  and torch.equal(g["greedy"], group[0]["greedy"])
                  for g in group), f"lm_mesh(a): the ranks of data shard "
              f"{d} emit different tokens")
    emit("lm_mesh", case="(a) serving, expert parallel, 4 gloo ranks",
         arch=c["arch"], layers=c["layers"], dtype="float32",
         capacity_factor=c["cf"], mesh=LM_MESH["mesh"],
         prompts=[c["batch"], c["seq"]], decode_steps=c["decode"],
         limits=dict(rtol=c["rtol"], atol=c["atol"]),
         reference_tokens=ref["tokens"].tolist(), per_rank=per_rank,
         ranks_wall_s=ab_s)

    # (b) training
    c = LM_MESH["train"]
    per_rank = []
    for r in ranks:
        t = r["train"]
        what = f"lm_mesh(b) rank {r['rank']} {r['coords']}"
        for a, b in zip(t["losses"], ref_train["losses"]):
            check(abs(a - b) <= c["loss_tol"], f"{what}: loss {a} against "
                  f"one device's {b} (limit {c['loss_tol']})")
        check(t["grad_max_rel"] <= c["grad_rel"], f"{what}: the first "
              f"batch's gradients differ from one device's by "
              f"{t['grad_max_rel']} of the leaf's max at "
              f"{t['grad_worst_leaf']} (limit {c['grad_rel']})")
        check(t["update_max_excess"] <= 0, f"{what}: the ZeRO-1 update "
              f"with one device's gradients exceeds rtol {c['rtol']}, atol "
              f"{c['atol']} by {t['update_max_excess']} at "
              f"{t['update_worst_leaf']}")
        check(t["path_max_rel"] <= c["path_rel"], f"{what}: the params "
              f"after {c['steps']} steps differ from one device's by "
              f"{t['path_max_rel']} of its change's norm at "
              f"{t['path_worst_leaf']} (limit {c['path_rel']})")
        check(not t["leaves_without_gradient"], f"{what}: leaves without a "
              f"gradient: {t['leaves_without_gradient']}")
        for n in t["launches_per_step"]:
            check(n == c["launches"], f"{what}: kernel launches a step "
                  f"{n}, not {c['launches']}")
        per_rank.append(dict(rank=r["rank"], coords=r["coords"], **{
            k: v for k, v in t.items() if k != "leaves_without_gradient"}))
    keep_counts(state, "lm_mesh[gloo train step, rank 0]", dict(
        {name: 0 for name in KERNEL_MODULES},
        **ranks[0]["train"]["launches_per_step"][-1]))
    keep_counts(state, "lm_mesh[gloo serve, rank 0]",
                ranks[0]["serve"]["launches"])
    emit("lm_mesh", case="(b) training, TP x DP x ZeRO-1, 4 gloo ranks",
         arch=c["arch"], layers=c["layers"], dtype="float32",
         optimizer="adamw", remat="dots", mesh=LM_MESH["mesh"],
         batch=[c["batch"], c["seq"]], steps=c["steps"],
         losses_one_device=ref_train["losses"],
         least_leaf_move_one_update=ref_train["least_leaf_move"],
         limits=dict(loss=c["loss_tol"], rtol=c["rtol"], atol=c["atol"],
                     grad_rel=c["grad_rel"], path_rel=c["path_rel"]),
         per_rank=per_rank,
         collectives_by_rank=[r["collectives"] for r in ranks])

    # (c) sequence-sharded decode
    c = LM_MESH["seq"]
    for r in seq:
        what = f"lm_mesh(c) rank {r['rank']}"
        check(r["gap"]["within"], f"{what}: logits exceed rtol "
              f"{c['rtol']}, atol {c['atol']} of the unsharded decode by "
              f"{r['gap']['max_excess']}")
        check(r["writes_owned_only"], f"{what}: positions written "
              f"{r['changed']}, owned {r['owned']}")
    emit("lm_mesh", case="(c) sequence-sharded decode, 2 gloo ranks",
         arch=c["arch"], layers=c["layers"], dtype="float32",
         prompt=c["prompt"], max_seq=c["max_seq"], decode_steps=c["decode"],
         mesh={"data": LM_MESH["seq_ranks"], "model": 1},
         limits=dict(rtol=c["rtol"], atol=c["atol"]),
         per_rank=[{k: v for k, v in r.items()} for r in seq],
         ranks_wall_s=seq_s)
    # (e) GaLore on the mesh
    c = LM_MESH["galore"]
    want_launches = galore_one["launches_a_step"]
    check(all(n == c["launches"] for n in want_launches),
          f"lm_mesh(e): one device's GaLore step launched {want_launches}, "
          f"not {c['launches']}")
    digests = galore[0]["galore"]["basis_digests"]
    check(len(digests) == 2 * galore_one["eligible_leaves"],
          f"lm_mesh(e): {len(digests)} bases in 2 refreshes of "
          f"{galore_one['eligible_leaves']} leaves")
    per_rank = []
    for r in galore:
        g = r["galore"]
        what = f"lm_mesh(e) rank {r['rank']} {r['coords']}"
        check(g["gram_max_rel"] <= c["gram_rel"], f"{what}: the gram of "
              f"{g['gram_worst_leaf']} differs from one device's by "
              f"{g['gram_max_rel']} of its max (limit {c['gram_rel']})")
        check(g["lonely_masks_equal"], f"{what}: lonely-row masks differ "
              f"from one device's")
        check(g["update_max_excess"] <= 0, f"{what}: the update with one "
              f"device's bases exceeds rtol {c['rtol']}, atol {c['atol']} by "
              f"{g['update_max_excess']} at {g['update_worst_leaf']}")
        check(g["basis_digests"] == digests, f"{what}: its bases differ in "
              f"their bits from rank 0's")
        for n in g["launches_per_step"]:
            check(n == want_launches[0], f"{what}: kernel launches a step "
                  f"{n}, one device's {want_launches[0]}")
        per_rank.append(dict(rank=r["rank"], coords=r["coords"], **{
            k: v for k, v in g.items() if k != "basis_digests"}))
    keep_counts(state, "lm_mesh[gloo galore step, rank 0]", dict(
        {name: 0 for name in KERNEL_MODULES},
        **galore[0]["galore"]["launches_per_step"][-1]))
    emit("lm_mesh", case="(e) GaLore over the mesh, 4 gloo ranks",
         arch=c["arch"], layers=c["layers"],
         hybrid_attn_every=c["attn_every"], dtype="float32",
         optimizer="galore", rank=c["rank"], update_every=c["update_every"],
         remat="dots", mesh=LM_MESH["mesh"], batch=[c["batch"], c["seq"]],
         steps=c["steps"], one_device=galore_one,
         limits=dict(gram_rel=c["gram_rel"], rtol=c["rtol"],
                     atol=c["atol"]),
         bases_bit_identical_on_every_rank=True,
         bases_compared=len(digests), per_rank=per_rank,
         one_device_s=galore_one_s, ranks_wall_s=galore_s)
    emit("lm_mesh_done", seconds=time.perf_counter() - t_phase,
         clocks="host clock between device synchronizations; ranks: "
                "processes on the one card over gloo (CUDA tensors staged "
                "through host memory); peaks are each rank's "
                "torch.cuda.max_memory_allocated")



# ---------------------------------------------------------------------------
# Phase launch: the dry run's counter against this run's times
# ---------------------------------------------------------------------------

# The runs of this script the counter prices: zamba2-2.7b's train step of
# phase lm_train (b) and gemma2-9b's prefill of phase lm_families; then
# one production cell of the dry run.
LAUNCH = dict(train="zamba2-2.7b train step",
              prefill="gemma2-9b prefill",
              cell=("phi4-mini-3.8b", "train_4k"))


def priced(label, fn, args, measured_ms) -> dict:
    """``fn(*args)`` on ``meta`` under the cost counter, its roofline
    bound max(t_compute, t_memory) on the H100 model beside the time this
    script measured for the same work on the card."""
    from repro_torch.launch import hlocost
    from repro_torch.launch import roofline as rl

    t0 = time.perf_counter()
    cost = hlocost.analyze(fn, *args)
    t_compute = cost.flops / rl.PEAK_FLOPS * 1e3
    t_memory = cost.bytes / rl.HBM_BW * 1e3
    bound_ms = max(t_compute, t_memory)
    check(bound_ms <= measured_ms, f"launch: {label}: the counter's bound "
          f"{bound_ms:.1f} ms is above the measured {measured_ms:.1f} ms, "
          f"so its count is wrong")
    return dict(run=label, flops=cost.flops, bytes=cost.bytes,
                t_compute_ms=t_compute, t_memory_ms=t_memory,
                bound_ms=bound_ms, measured_ms=measured_ms,
                bound_over_measured=bound_ms / measured_ms,
                kernel_calls=cost.kernel_calls,
                temp_peak_bytes=cost.peak_bytes,
                count_host_s=time.perf_counter() - t0)


def phase_launch(state) -> None:
    """(a) The dry run's counter (``launch/hlocost.py``) prices two runs
    this script timed on the card, each on ``meta`` in this process: the
    bound max(t_compute, t_memory) of ``launch/roofline.py``'s H100 model
    must not be above the measured time.  (b) ``dryrun.run_cell`` of one
    production cell on the 16 x 16 counting mesh."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.io import train_batch

    t_phase = time.perf_counter()
    measured = state.get("measured", {})
    for key, phase in (("train", "lm_train (b)"), ("prefill", "lm_families")):
        check(LAUNCH[key] in measured,
              f"launch: needs {phase} in the same run, for {LAUNCH[key]}")
    rows = []
    # zamba2-2.7b's train step of lm_train (b), on the host mesh (1, 1)
    m = measured[LAUNCH["train"]]
    cfg = get_config(LM_ARCH)
    tcfg = m["tcfg"]
    ctx = ShardCtx(mesh=make_host_mesh(1, "meta"))
    params = schema.abstract_params(cfg)
    tstate = {"params": params,
              "opt": train_step.init_opt_state(tcfg, params, cfg, ctx),
              "seed": 1}
    batch = train_batch(cfg, m["batch"], m["seq"], abstract=True)
    rows.append(dict(priced(
        f"{LAUNCH['train']} {m['batch']} x {m['seq']}, host mesh (1, 1)",
        train_step.make_train_step(cfg, tcfg, ctx), (tstate, batch),
        m["ms"]), measured_least_ms=m["least_ms"]))
    del tstate, params
    # gemma2-9b's prefill of lm_families
    m = measured[LAUNCH["prefill"]]
    cfg = get_config(WIDE_ATTN_ARCH)
    params = schema.abstract_params(cfg)
    batch = train_batch(cfg, m["batch"], m["seq"], abstract=True)
    batch.pop("labels")

    def prefill(params, batch):
        with torch.no_grad():
            return transformer.prefill_forward(cfg, params, batch,
                                               max_seq=m["max_seq"])

    rows.append(priced(f"{LAUNCH['prefill']} {m['batch']} x {m['seq']}",
                       prefill, (params, batch), m["ms"]))
    emit("launch", case="(a) the counter's bound beside the card's time",
         hardware_model="H100 SXM: 989e12 bf16 FLOP/s, 3.35e12 B/s",
         rows=rows)
    t0 = time.perf_counter()
    row = dryrun.run_cell(*LAUNCH["cell"], multi_pod=False, verbose=False)
    check(row["ok"], f"launch(b): the dry-run cell failed: "
          f"{row.get('error')}")
    emit("launch", case="(b) dry-run cell on the 16 x 16 counting mesh",
         row=row, host_s=time.perf_counter() - t0)
    emit("launch_done", seconds=time.perf_counter() - t_phase)


FT_RANK = 16
FT_SLOTS = 8


def phase_ft(state) -> None:
    """Fault tolerance on the card: the paper rows (sparse batches of 64,
    rank 16) through the supervised stream over a LocalMesh of 8 slots.
    (a) Unfaulted, obs off: the supervised stream against the same
    chunks of ``svd_stream`` on the same pool: the same bits, one
    ``sparse_gram`` launch or more a committed chunk, and the host syncs
    of the chunks plus exactly the commit's one device to host copy a
    chunk (sync debug mode).  (b) The three chaos scenarios of
    ``scripts/chaos_run_torch.py`` (their asserts: resumed factors
    ``torch.equal`` to the uninterrupted run, Leg B within 1e-5 of S[0] of
    a single-host run, the recover.* spans), obs on: recovery ms by stage,
    the replayed chunk's ms, and R8's measured restore transient against
    ``recovery_restore_bytes`` (within the drift factor)."""
    import tempfile
    from repro_torch.core.collectives import LocalMesh

    t_phase = time.perf_counter()
    chaos = load_script("chaos_run_torch")
    coo = state["coo"]
    batches = paper_batches(coo)
    stream = chaos.Stream(batches, coo.shape[1], FT_RANK, DEVICE)
    check(chaos.SLOTS == FT_SLOTS, "ft: the scenarios' pool changed")
    cfg = chaos.config(stream, num_blocks=4)
    every = cfg.checkpoint_every
    chunks = -(-len(batches) // every)
    torch.cuda.empty_cache()

    def plain():
        # The supervisor's placement: one slot a column block (so rule R5d
        # picks shard_map).
        stream_state.set_stream_devices(LocalMesh(cfg.num_blocks, DEVICE))
        try:
            st = api.svd_init(stream.n, cfg, device=DEVICE)
            for i in range(0, len(batches), every):
                st = api.svd_stream(batches[i:i + every], cfg,
                                    state=st).state
            return stream_state.gather_state(st)
        finally:
            stream_state.set_stream_devices(None)

    def supervised():
        return chaos.supervised(cfg, stream)

    check(not obs.enabled(), "ft: obs is on before the phase")
    plain()
    supervised()                                          # warm
    runs = {}
    for name, fn in (("plain", plain), ("supervised", supervised),
                     ("supervised_again", supervised), ("plain_again", plain)):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, sites = sync_sites(fn)
        torch.cuda.synchronize()
        runs[name] = dict(out=out, sites=sites, syncs=sum(sites.values()),
                          ms=(time.perf_counter() - t0) * 1e3,
                          launches=read_counts())
    ref = runs["plain"]["out"]
    for name in ("supervised", "supervised_again"):
        final, sup = runs[name]["out"]
        check(chaos.bitwise(final, ref), f"ft: the {name} stream differs "
              f"from the plain chunks")
        check(len(sup.chunk_seconds) == chunks, f"ft: {name} committed "
              f"{len(sup.chunk_seconds)} chunks, want {chunks}")
        check(runs[name]["launches"]["sparse_gram"] >= chunks,
              f"ft: {name} launched sparse_gram "
              f"{runs[name]['launches']['sparse_gram']} times for "
              f"{chunks} committed chunks")
        for base in ("plain", "plain_again"):
            check(runs[name]["syncs"] == runs[base]["syncs"] + chunks,
                  f"ft: {name} made {runs[name]['syncs']} host syncs, "
                  f"{base} {runs[base]['syncs']} + {chunks} commits "
                  f"({runs[name]['sites']} vs {runs[base]['sites']})")
    keep_counts(state, "ft[supervised]", runs["supervised"]["launches"])

    scenarios = []
    factor = obs.gate.drift_factor()
    with tempfile.TemporaryDirectory() as tmp:
        for scenario in ("kill-at-batch", "persistent-straggler",
                         "kill-during-merge"):
            t0 = time.perf_counter()
            doc, sup = chaos.run(scenario, os.path.join(tmp, "ev.json"),
                                 stream=stream)
            secs = time.perf_counter() - t0
            stages = {}
            for e in obs.trace.events():
                if e.name.startswith("recover.") and e.ph == "X":
                    stages.setdefault(e.name, []).append(e.dur_us / 1e3)
            check(set(stages) == {"recover.drain", "recover.replan",
                                  "recover.restore"},
                  f"ft[{scenario}]: recovery spans {sorted(stages)}")
            resumed = {e.resumed_from_batch for e in sup.events
                       if e.kind != "collective_retry"}
            replay = [c[2] * 1e3 for c in sup.chunk_seconds
                      if c[0] in resumed]
            r8 = [r for r in obs.drift.monitor().records()
                  if r["rule"] == "R8"]
            check(r8, f"ft[{scenario}]: no R8 restore measured")
            for r in r8:
                check(r["ratio"] <= factor, f"ft[{scenario}]: R8 restore "
                      f"transient {r['measured']} B is {r['ratio']} of "
                      f"{r['estimated']} B (limit {factor})")
            scenarios.append(dict(
                scenario=scenario, seconds=secs,
                events=[e.kind for e in sup.events],
                backends=[f"{e.backend_before}->{e.backend_after}"
                          for e in sup.events],
                recover_ms=stages, replay_chunk_ms=replay,
                event_wall_ms=[e.wall_s * 1e3 for e in sup.events],
                r8=[dict(label=r["label"], measured=r["measured"],
                         estimated=r["estimated"], ratio=r["ratio"])
                    for r in r8],
                **{k: v for k, v in doc.items()
                   if k in ("legB_rel_err", "backup_saved_s")}))
    obs.reset()
    emit("ft", rows=list(coo.shape), batches=len(batches),
         batch_rows=STREAM_BATCH_ROWS, rank=FT_RANK, slots=FT_SLOTS,
         num_blocks=cfg.num_blocks, checkpoint_every=every,
         committed_chunks=chunks,
         unfaulted={name: dict(ms=r["ms"], host_syncs=r["syncs"],
                               host_syncs_per_batch=r["syncs"] / len(batches),
                               sync_sites=r["sites"],
                               launches=r["launches"])
                    for name, r in runs.items()},
         scenarios=scenarios, drift_factor=factor,
         seconds=time.perf_counter() - t_phase,
         clocks="ms: host clock, device synchronized at both ends; "
                "recover_ms: the supervisor's recover.* spans of every "
                "recovery the scenario ran, kill-at-batch's two legs "
                "included (host clock; the restore's device copies "
                "synchronize); replay_chunk_ms: "
                "the first committed chunk after each recovery (svd_stream "
                "plus the commit's copy)")


# (script, arguments, the kernels it must launch on the card): every SVD
# twin its gram kernels, with the default config (use_kernel=None), by its
# input: sparse_gram for COO batches, blockgram for dense ones; the LM twin
# at its default (mamba2: ssd_scan) and on zamba2 (both LM kernels).
EXAMPLES = (
    ("quickstart_torch.py", (), ("sparse_gram",)),
    ("streaming_svd_torch.py", (), ("sparse_gram", "blockgram")),
    ("streaming_svd_torch.py", ("--observe",), ("sparse_gram", "blockgram")),
    ("serving_topk_torch.py", (), ("topk_score",)),
    ("serving_topk_torch.py", ("--observe",), ("topk_score",)),
    ("serve_lm_torch.py", (), ("ssd_scan",)),
    ("serve_lm_torch.py", ("--arch", "zamba2-2.7b"),
     ("flash_attention", "ssd_scan")),
    ("distributed_svd_torch.py", (), ("sparse_gram",)),
    ("distributed_streaming_torch.py", (), ("sparse_gram", "blockgram")),
    ("elastic_ingest_torch.py", (), ("blockgram",)),
    ("train_lm_torch.py", ("--steps", "60"), ("flash_attention",)),
    ("gradient_compression_torch.py", ("--steps", "40"),
     ("flash_attention",)),
)
# Example processes on the card at once (the card's host has 8 cores).
EXAMPLE_WORKERS = 4
# The trainers' loss criterion (tests/test_system.py's): the last logged
# loss below this share of the first.
EXAMPLE_LOSS_DROP = 0.85


def run_example(root, env, script, args):
    """(the finished process, its wall seconds)."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.join(root, "examples", script), *args],
        env=env, capture_output=True, text=True, timeout=600)
    return proc, time.perf_counter() - t0


def phase_examples(state) -> None:
    """The nine twins (the LM twin twice), each a process of its own on
    the card, ``EXAMPLE_WORKERS`` of them at once (each is smoke-sized;
    most of a process's wall is its start: the interpreter, torch, the
    kernel library)."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    runs = []
    torch.cuda.empty_cache()
    with concurrent.futures.ThreadPoolExecutor(EXAMPLE_WORKERS) as pool:
        done = [pool.submit(run_example, root, env, script, args)
                for script, args, _ in EXAMPLES]
        results = [f.result() for f in done]
    for (script, args, kernels), (proc, secs) in zip(EXAMPLES, results):
        name = " ".join((script,) + args)
        check(proc.returncode == 0, f"examples: {name} exited "
              f"{proc.returncode}:\n{proc.stdout[-2000:]}\n"
              f"{proc.stderr[-4000:]}")
        last = proc.stdout.strip().splitlines()[-1]
        check(last.startswith("summary "), f"examples: {name} printed no "
              f"summary line")
        summary = json.loads(last[len("summary "):])
        launches = summary["launches"]
        for kernel in kernels:
            check(launches[kernel] >= 1, f"examples: {name} never launched "
                  f"{kernel}")
        if "drift" in summary:      # --observe: every rule within the gate
            factor = obs.gate.drift_factor()
            check("DriftWarning" not in proc.stderr
                  and all(r <= factor for r in summary["drift"].values()),
                  f"examples: {name}: drift {summary['drift']} (limit "
                  f"{factor}){' with a DriftWarning' if 'DriftWarning' in proc.stderr else ''}")
        if "waves" in summary:      # one launch a wave: live ones + 4 more
            check(launches["topk_score"] == summary["waves"] + 4,
                  f"examples: {name}: topk_score launched "
                  f"{launches['topk_score']} times for "
                  f"{summary['waves']} + 4 waves")
        trained = [summary] if "first_loss" in summary else \
            list(summary.get("runs", {}).values())
        for run in trained:
            check(run["last_loss"] < EXAMPLE_LOSS_DROP * run["first_loss"],
                  f"examples: {name}: the last logged loss {run['last_loss']}"
                  f" is not below {EXAMPLE_LOSS_DROP} x the first "
                  f"{run['first_loss']}")
        runs.append(dict(example=name, seconds=secs, **summary))
        keep_counts(state, f"examples[{name}]", launches)
    emit("examples", runs=runs, workers=EXAMPLE_WORKERS,
         clocks="wall seconds of each process, interpreter start and the "
                "kernel library's load included, beside the others")


def main(argv=None) -> int:
    """No arguments: every phase (the contract's run).  ``--only a,b``
    runs the named phases alone (their ``phase_`` names without the
    prefix), prints no ``kernels`` line and ends with ``{"only": [...],
    "ok": true}``: for working on a phase, not a whole run."""
    argv = sys.argv[1:] if argv is None else argv
    only = set()
    if argv[:1] == ["--only"] and len(argv) == 2:
        only = set(argv[1].split(","))
    elif argv:
        print(f"chip_smoke: unknown arguments {argv}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this script only "
              "runs on the GPU", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    emit("device", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0],
         allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)
    check(torch.backends.cuda.matmul.allow_tf32 is False,
          "TF32 must be off for matrix products")
    check(torch.backends.cudnn.allow_tf32 is False,
          "TF32 must be off for cuDNN")

    kernel_build.load()
    emit("build", nvcc_seconds=kernel_build.build_seconds,
         sources=[str(s.name) for s in kernel_build.sources()],
         flags=" ".join(kernel_build.NVCC_FLAGS))

    state = {}
    cfg = RankyPaperConfig()
    t0 = time.perf_counter()
    state["coo"] = bipartite.paper_coo(cfg)
    state["ell"] = sparse.block_ell_from_coo(state["coo"], NUM_BLOCKS,
                                             device=DEVICE)
    emit("data", shape=list(state["coo"].shape), nnz=state["coo"].nnz,
         num_blocks=NUM_BLOCKS, ell_capacity=list(state["ell"].capacity),
         host_seconds=time.perf_counter() - t0)

    phase_seconds = {}
    for phase in (phase_kernels, phase_solve_sparse_exact,
                  phase_solve_dense_exact, phase_solve_randomized,
                  phase_solve_scaled, phase_stream_exact, phase_stream_serve,
                  phase_serve_scaled, phase_hierarchical, phase_stream_window,
                  phase_merge_driver_ab, phase_lm_serve,
                  phase_lm_families, phase_lm_moe_encdec, phase_lm_train,
                  phase_checkpoint,
                  phase_observe, phase_lint, phase_trace,
                  phase_drift_stages, phase_distributed, phase_lm_mesh,
                  phase_launch, phase_ft, phase_examples):
        if only and phase.__name__[len("phase_"):] not in only:
            continue
        t_phase = time.perf_counter()
        phase(state)
        torch.cuda.synchronize()
        phase_seconds[phase.__name__[len("phase_"):]] = \
            time.perf_counter() - t_phase
    if only:
        print(json.dumps({"only": sorted(only), "ok": True}), flush=True)
        return 0

    by_solve = state["launches_by_solve"]
    kernels = []
    for name, info in KERNEL_INFO.items():
        launches = by_solve[info["launches_in"]][name]
        check(launches >= 1,
              f"{name} was never launched by {info['launches_in']}")
        kernels.append(dict(
            name=name, **info, launches=launches,
            launches_by_solve={solve: counts[name]
                               for solve, counts in by_solve.items()},
            **{key: value for key, value in state["kernel_main"][name]
               .items() if key != "checked"}))
    emit("phase_seconds", **phase_seconds)
    emit("stage_summary", **state["stage_summary"])
    print(json.dumps({"kernels": kernels}), flush=True)
    emit("done", seconds=time.perf_counter() - t_start)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
