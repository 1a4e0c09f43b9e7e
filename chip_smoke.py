#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            (from the repository root, one CUDA card)
    python3 chip_smoke.py --kernels rmsnorm,wkv6   (phases 1-3 for those only)
    python3 chip_smoke.py --kernels decode_attention,flash_attention \
        --tree build/parent --save FILE          (a parent's kernels, this harness)
    python3 chip_smoke.py --compare FILE FILE ...  (K1's saved outputs bit-identical?)
    python3 chip_smoke.py --skip-serving           (phases 1-3, 6-13, 14-16 (b, c) and 17)
    python3 chip_smoke.py --only-moe               (phases 1-3 and 14)
    python3 chip_smoke.py --only-hybrid            (phases 1-3 and 15)
    python3 chip_smoke.py --only-audio             (phases 1-3 and 16)
    python3 chip_smoke.py --only-dryrun            (phases 1-3 and 18)
    python3 chip_smoke.py --only-large             (phases 1-3 and 19)

Phases, each of which raises (exit code != 0) on failure:

1. Device: the card's name, count, and ``nvidia-smi`` name / power limit.
2. Build: ``nvcc`` for sm_90a of every kernel under ``src/repro_torch/csrc``,
   one compiler per source, all started together; ptxas's register, shared
   memory and spill report per kernel.
3. Kernels against their plain PyTorch versions on the card, in bf16, at the
   serving paths' shapes (RMSNorm at both models' widths, 4096 and 2560,
   and the MoE models' 2048; K1 and K3 also at deepseek-moe-16b's serving
   shapes, 16 heads over 16 KV heads, timed, and K1 at qwen3-vl-30b-a3b's
   training sequence, 32 heads over 4; K1 and K3 at zamba2-7b's head_dim
   112, 32 heads over 32, timed, each with a ragged case and a one-key
   control; RMSNorm at zamba2-7b's 3584 and 7168; K1 and K3 at
   musicgen-medium's head_dim 64, 24 heads over 24, over its 128-frame
   prefix and 1000 frames, timed, each with a one-key control, and at
   qwen1.5-32b's 40 heads over 40; RMSNorm at musicgen-medium's 1536 and
   qwen1.5-32b's 5120, timed; at rep 16, K3 at llama3-405b's decode shape,
   128 heads over 8, and qwen3-moe-235b-a22b's, 64 over 4, and at rep 8,
   deepseek-67b's, 64 over 8, and qwen3-vl-30b-a3b's, 32 over 4 (both on
   the tensor cores), timed with a one-key control, and at dh 64 and 112,
   and K1 at llama3-405b's prefill, timed with a one-key control; RMSNorm at llama3-405b's 16384; K3's
   partial form over the cache cut into 4 position pieces, the last past
   cur_index (no launch), combined, against K3 over the whole cache and the
   plain version at rep 4 and rep 16, with a piece left out as the control;
   RMSNorm handed each row's mean square against itself without it and the
   plain version, four times the mean square the control) plus a ragged and
   a tiny case each:
   max |err| and
   the worst element's share of its limit (one bf16 ulp of the value plus
   1-2% of its output vector's RMS; see KERNEL_RTOL), with a one-key fault that the
   check must refuse for each attention kernel and two for WKV6 (u zeroed:
   y refused; the last token's k zeroed: the state refused); the kernel's and the plain
   version's time (CUDA events, per launch after warm-up, L2 flushed before
   each launch), one PyTorch library call of the same function as a
   yardstick (never used by the port; WKV6 has none), and the least time the card could
   take (bytes over 3.35 TB/s, operations over the peak rate for their
   type). K5, AdamW, in fp32 over the leaf lists of the benchmark's
   training cuts (granite-8b at 8 layers, qwen3-vl-30b-a3b at 4): a step's
   device time beside its bound (32 B a parameter) and the plain loop's;
   at granite's list bit-identical to the plain loop at K5's clip scale,
   one ulp more scale on one leaf the control; then one bf16 leaf of
   2^31 + 5 elements bit for bit. No library call computes the clipped
   update.
4. Serving at full width: granite-8b (36 layers, d_model 4096) with random
   weights from a seeded torch generator, cast once to bf16, serves 8
   requests of 1000-token prompts, 32 new tokens each, through
   ``ServeEngine.run_batch`` (the weights drawn leaf by leaf, each cast as
   it is drawn). Launch counts are reset just before and read
   just after: 73 RMSNorm + 36 flash-attention launches per prefill, 73
   RMSNorm + 36 flash-decode launches per decode step. Then torch.profiler
   reads the device-busy share of one prefill and of 8 decode steps, and a
   2-layer cut of the same weights holds prefill logits and three decode
   steps' logits, kernels against plain versions on the card.
5. The same for rwkv6-3b (32 layers, d_model 2560) through the model-level
   API (``prefill``, then greedy ``decode_step`` over the recurrent state,
   the host reading each token; ``ServeEngine`` refuses the RWKV family as
   the JAX engine does): 32 WKV6 + 97 RMSNorm launches per prefill, 97
   RMSNorm and no WKV6 per decode step, no attention kernel. The granite
   engine is freed first.

6. Training at full width: granite-8b cut to 8 of its 36 layers (fp32
   parameters, gradients and Adam moments of all 36 would take 132 GB) takes
   3 AdamW steps on one batch of 4 x 1024 tokens through
   ``repro_torch.train.make_train_step`` (remat on, one microbatch). Per
   step: loss, grad norm, learning rate, step ms (host clock to a
   synchronise), tokens/s and launches against the count expected from the
   config: with remat each forward kernel launches in the forward and again
   in the layer's recompute, and the final norm, outside the layers, once.
   Then one step under torch.profiler (its 8 largest device lines, the
   device-busy share, each forward kernel's share) with CUDA events around
   each backward rule and the AdamW update, which give their shares.
7. The same for rwkv6-3b at full width and depth (32 layers).
8. One train step's loss, gradients and grad norm on a 2-layer full-width
   cut of each model, kernel path against plain path (``plain_path``), from
   the same fp32 parameters and batch: loss within TRAIN_LOSS_RTOL, each
   gradient leaf's RMS(diff) / RMS(plain) within GRAD_RMS_TOL, grad norm
   within GRAD_NORM_RTOL; one negative control per model changes only one
   kernel's backward rule (K1's recompute without the causal mask; K4's on
   time-reversed inputs), and the check must refuse it.
9. fig17's three arms (``benchmarks/fig17_fused_train.py``) on the card:
   the granite-8b cut of phase 6 trained through ``FusedTrainLoop`` off
   each data plane, at depth 0 then 2, colocated, mq, tgb at each depth, 2
   warm-up and 6 timed steps an arm, every arm from one saved copy of the
   state on the card. The stream is 14 global batches of 4 x 1024 tokens
   (vocab 49152) at dp 2 x cp 2. colocated: fig17's worker pool
   (``ColocatedConfig()``, 0.2 ms a sample, 4 sample indices a pull, each
   index its 1024-token slice of the stream) packed by
   ``PackingTokenSource`` on the staging thread; mq: one message a TGB in a
   ``KafkaSimBroker(BrokerConfig())``, whole-message fetches by one reader
   per (d, c); tgb: TGBs in a ``MemoryObjectStore`` with the S3-class
   ``LatencyModel()``, one reader per (d, c) range-reading its 4 KiB slice
   (prefetching 4 at depth 2). Every tgb and mq grid must equal the host
   packer's, every colocated grid the packer's grid over the slices its
   delivered indices name, every step's device tokens its host tokens and
   its launches phase 6's, the mq and tgb arms' losses at one depth
   bit-identical, and the mq readers' read amplification above D x C.
   Printed per arm: tokens/s at the median step (fig17's reading) and over
   the run, the data_wait / h2d / compute / other split,
   compute_vs_roofline against ``launch/roofline.ideal_step_s`` (6 N
   tokens / 989 TFLOP/s), K2 and K1 launches a step, peak memory. The
   phase raises on ``benchmarks/check_fig17.py``'s gates for the tgb arm
   at depth 2 (data_wait < 15%, >= 0.9x the colocated arm's tokens/s,
   >= 1.15x its depth-0 arm's, whose data_wait is 0.1 higher) and their
   roofline cross-check; then a replay of the tgb depth-2 arm's steps 2-4
   from a cursor snapshot, byte-identical, with the readers' cursors at the
   consumed frontier after ``stop()``; the tgb depth-2 arm runs 2 more
   steps under torch.profiler; a source that swaps each grid's two DP
   halves must be refused.

10. The cut of phase 9, with its settings (dp 2 x cp 2, 4 x 1024 tokens,
   depth 2, readers prefetching 4), trained through a ``TrainSession`` on
   a ``MemoryObjectStore`` with a ``FaultInjector`` and no latency model, so
   the times are the port's own (device to host, serialisation, host to
   device): 4 steps, ``FusedTrainLoop.aligned_checkpoint`` (it must bind
   step 4, the consumed frontier, not the staged ring), a checksum pair of
   each leaf's bits on the card, ``reclaim``, 3 more steps (run A's steps
   5-7), then a second aligned checkpoint killed between its upload and
   its RunManifest commit (``InjectedCrash``). The loop, the session and
   the state are freed; ``TrainSession.resume`` must give ``resume_step``
   4, ``restore_model`` into a fresh template on the card must give every
   leaf's checksums, and a new loop's 3 steps must consume run A's grids
   byte for byte with losses within RESUME_LOSS_RTOL. The negative control
   restores the killed upload (no entry binds it) with the aligned cursor
   and trains one step: the loss check must refuse it. ``fsck`` must report
   no error and the killed upload as pending. Printed, each beside the
   card's name and power limit: the state's bytes, the host's MemAvailable,
   upload seconds and GB/s, commit ms, resume + restore seconds and GB/s,
   the wall from resume to the end of the first resumed step, peak device
   memory, launches (K2 / K1 / K3 / K5: 33 / 16 / 0 / 3 a step) and the
   phase's seconds.

11. Failure isolation and a brownout on the cut of phase 9 (depth 2, 12
   steps a run, one state): (a) the colocated pool dies after step 3
   (``inject_crash``) and the loop must raise ``BatchTimeout`` within its
   5 s timeout, which the isolation check (every step run, every grid the
   packer's, once) refuses: the negative control; (b) a live tgb producer
   thread (``run_producer_loop``, 0.2 s a TGB) dies before its 5th TGB
   without finalizing, a replacement writer recovers on enter from the
   manifest 1 s later and continues, and the trainer must pass the same
   check, with the data_wait of the steps around the kill printed; the
   session's flight recorder is on (every OBS_SNAP_S), and the operator
   CLI's ``top`` and ``obs --json`` (``repro_torch.ops.main``, in process)
   over ``runs/kill`` must render the killed incarnation of ``w0``'s
   producer from storage alone, with work in its last snapshot, and the
   replacement as another incarnation, no rate taken across the two; (c) the
   tgb arm through ``FaultyObjectStore(MemoryObjectStore(LatencyModel()),
   FaultPolicy(slow_get_rate=0.15, slow_get_s=0.06))`` with fig16's storm
   (``BrownoutPhase(target_rate=120, retry_after_s=0.1)``) over the middle
   third of the run, ``resilience=`` fig16's client, a live producer with
   ``spill_limit=256`` and flight-recorder snapshots: grids and losses
   bit-identical to a fault-free run from the same state, throttles seen >
   0, the data_wait share of each third, the producer's latest
   snapshot under ``<ns>/obs/`` equal to the live registry, and the
   resilient store's ``throttled`` in ``obs --json`` over ``runs/brownout``
   equal to the live registry's.

12. The cut of phase 9 through a ``TrainSession`` over a weighted mix
   (``streams={"web": 0.5, "code": 0.3, "filtered": 0.2}``, ``mix_seed=11``)
   on a ``MemoryObjectStore`` with a ``FaultInjector`` and no latency model,
   at dp 2 x cp 1 (the derive worker decodes a source TGB as its DP slices
   joined, whole rows only at cp 1), depth 2, readers prefetching 4, 14
   steps. ``web``: one live producer thread (0.2 s a TGB) of seeded token
   grids; ``code``: claimed as 4 shard chains before any write, written by
   two live producers ``p0`` and ``p1``; ``filtered``: derived live from
   ``web`` by a ``DeriveWorker`` (keep rows whose first token is even, pack
   into 4 x 1024 grids, windows of 2 source TGBs) that the FaultInjector
   kills at its second window's cursor commit, after that window's uploads;
   a replacement 0.5 s later replays the window from the committed cursor
   with no upload (every content address present). Every step's grid must
   be the one the schedule names (the packer's for ``web`` and ``code``,
   ``code``'s in its merged manifest order, the host's own derivation for
   ``filtered``), the device tokens the host's, the ``filtered`` stream the
   host's derivation byte for byte. After step 6 an aligned checkpoint must
   bind step 6 and a composite token at mix position 6, then ``reclaim`` and
   a ``Compactor`` cycle on ``code`` at its trim marker (or the checkpoint's
   ``code`` watermark) must fold entries into a segment with the shard bases
   at the segment's folds; steps 7-14 follow. The state is freed; the run
   resumed with ``web``'s and ``code``'s weights swapped must be refused (the
   MixPlan ``ValueError``); ``TrainSession.resume`` must give step 6, the
   bound leaves bit for bit, and 8 steps replaying run A's grids 7-14 with
   losses within RESUME_LOSS_RTOL (``code`` cold-starts through the
   segment); the token with ``code``'s cursor one step back must be refused
   by the restore and, forced under a restored reader, by the schedule
   guard; fsck must report no error, see the derive cursors and the shard
   bases at the segment's folds. Then the operator CLI in process over the
   phase's store (the checkpoints, three streams): ``inspect --json`` must
   equal ``inspect_run``, ``fsck --json`` exit 0 with the encoding of the
   phase's fsck report, ``trim --ranks 2 --json`` run one cycle a stream and
   ``fsck`` exit 0 after it. Printed, each beside the card's name and
   power limit: tokens/s at the median step, the split, the derive worker's
   TGBs, uploads and hits before and after the kill, the compactor's cycle,
   the checkpoint's upload and commit, resume + restore, each CLI
   command's ms, peak memory, launches (K2 / K1 / K5: 33 / 16 / 3 a step)
   and the phase's seconds.

13. The chaos harness and the operator CLI's entry points, host code that
   launches no kernel, as subprocesses from the repository root with
   ``PYTHONPATH=src``: (a) ``python -m repro_torch.chaos --json --seed S``
   for each of CHAOS_SEEDS at once (the last with ``--trace``): every
   scenario of CHAOS_SCENARIOS must pass with fsck clean after, each one's
   steps delivered, orphans, faults injected and recovery ms printed;
   ``--list`` must name the same scenarios and the trace hold spans. (b)
   ``python -m repro_torch.ops --root DIR -n runs/job`` over a
   ``FileObjectStore`` run built as ``tests/test_ops.py``'s ``file_run``
   with a planted orphan TGB: ``--json fsck`` 1 (naming the orphan),
   ``fsck --repair`` 1, ``fsck`` 0, ``inspect``, ``trim``, ``top`` 0, and a
   ``--root`` that does not exist 2, each command's ms printed.

14. The MoE family and the vision prefix. (a) deepseek-moe-16b (28 layers,
   d_model 2048, 64 routed experts top-6 and 2 shared, 16 heads of 128 over
   16 KV heads) served as phase 4 serves granite-8b (skipped under
   ``--skip-serving``): the weights drawn leaf by leaf on the card and each
   cast to bf16 as it is drawn (the whole fp32 tree, 62.9 GiB, beside its
   bf16 copy would not fit); 57 RMSNorm + 28 flash-attention launches per
   prefill, 57 RMSNorm + 28 flash-decode per decode step; each layer's share
   of dropped choices in a prefill (capacity 940 a expert; a decode step's
   is 4); the profile; the 2-layer cut, kernels vs plain, with the plain
   path replaying the kernel path's routing (``RoutingReplay``; routing is
   discontinuous, and a near-tied choice tipped by bf16 rounding would move
   whole FFN outputs) and the choices it would have made otherwise printed.
   (b) qwen3-vl-30b-a3b, the paper's own training target, cut to 4 of its
   48 layers at full width (32 heads of 128 over 4 KV heads, 128 experts
   top-8): 3 AdamW steps as phase 6 on 4 x 1024 tokens after 128 seeded fp32
   frame embeddings a row (the reference's prefix length for S 1024),
   1152 positions; loss, aux loss, launches, the profile. (c) Its 2-layer
   cut's train step, kernels vs plain under the kernel path's routing, with
   phase 8's K1 control refused.

15. The Mamba2 / Zamba2 hybrid (``models/mamba2.py``). (a) zamba2-7b (81
   Mamba2 layers, d_model 3584, one shared attention block of 32 heads of
   112 after every 6 of them, 13 invocations) served as phase 5 serves
   rwkv6-3b (``prefill`` into a preallocated state, then greedy
   ``decode_step``; ``ServeEngine`` refuses the hybrid as the JAX engine
   does; skipped under ``--skip-serving``), its weights drawn leaf by leaf
   and cast: 189 RMSNorm + 13 flash-attention launches a prefill, 189
   RMSNorm + 13 flash-decode a decode step, no WKV6; the profile. (b) Its
   7-layer cut at full width (one group of 6 and the shared block, then a
   tail layer) trains 3 AdamW steps as phase 6; with the nested remat a
   Mamba2 layer inside the group runs forward three times, the shared
   block and the tail layer twice: 45 RMSNorm + 2 flash-attention
   launches a step. (c) The same cut, kernels vs plain: prefill logits and
   three decode steps' (bf16 weights; the control moves each head's K1 and
   K3 output onto the next head and must be refused at every step), then
   one train step's loss and gradients (phase 8's K1 control refused).

16. The audio family (the audio branches of ``models/transformer.py`` and
   ``models/model.py``). (a) musicgen-medium (48 layers, d_model 1536, 24
   heads of 64 over 24 KV heads, 4 codebooks of 2048) served through
   ``prefill`` + ``decode_step`` (``ServeEngine`` refuses the audio family,
   on which the JAX engine fails; skipped under ``--skip-serving``): 8
   prompts of 1000 frames of 4 codebooks after 128 seeded frame embeddings,
   prefilled into a state of 1160 positions, then 31 greedy decode steps of
   (8, 4) tokens at positions 1128 onward; 97 RMSNorm + 48 flash-attention
   launches a prefill, 97 RMSNorm + 48 flash-decode a decode step; frames/s
   and codebook tokens/s; the profile. (b) The same model at full depth
   trains 3 AdamW steps as phase 6 on 4 x 1024 frames of 4 codebooks after
   128 frame embeddings (the loss one mean over the (S-1)·4 codebook
   positions of a row): 193 RMSNorm + 96 flash-attention launches a step.
   (c) Its 2-layer cut, kernels vs plain: prefill logits (8, 4, 2048) and
   three decode steps' (the control moves each head's K1 and K3 output onto
   the next head and must be refused at every step), then one train step's
   loss and gradients (phase 8's K1 control refused); and qwen1.5-32b's
   2-layer full-width cut (40 heads of 128, a QKV bias) the same way as its
   serving cut, with the heads control.

17. The port's data-plane examples, host code that launches no kernel, in
   process (``runpy``) from the repository's ``examples/``:
   ``quickstart_torch.py`` (two producers, four readers at dp 2 x cp 2,
   watermarks, a reclaim, a replacement writer), ``failover_torch.py``
   (a producer crash and its exactly-once takeover, a trainer killed
   between its model upload and its RunManifest commit, the aligned
   resume, a reclaim) and ``sft_mixture_torch.py`` (three weighted streams,
   one composite token, mix-aware reclamation, the resume). Each must
   finish with its own asserts held and tell its story (EXAMPLE_STORIES);
   each one's lines and seconds are printed, and the phase's wall seconds
   beside the ``nvidia-smi`` line.

18. The dry run of the port on the card's machine. (a) ``python -m
   repro_torch.launch.dryrun`` in one subprocess a cell, all at once, each
   within DRYRUN_TIMEOUT_S, over the named cells DRYRUN_CELLS on both
   production meshes (16x16, 2x16x16) with fake CUDA DTensors over the
   ``"fake"`` process group (no card needed; the 88-cell grid takes longer
   than this script's budget and runs in a call of its own): every record
   ``ok`` or the reference's ``skipped``; then ``python -m
   repro_torch.launch.roofline`` over the records, its rows printed with
   the cells' count and the wall. (b) The card check, on the full-width
   paths that launch K1-K4, each under ``torch.profiler`` read by
   ``launch.hlo_analysis.analyze_profile``: granite-8b's serving batch
   (phase 4's settings) must launch K1 36, K2 2336 and K3 1116 times; the
   granite 8-layer train step (phase 6's) K2 33 and K1 16 times; rwkv6-3b's
   prefill K2 97 and K4 32 times, by the wrappers' counts exactly and by
   the profile's kernel names (its tracer drops a session's first device
   events, so TRACER_MARKERS spin kernels open each profile and one at
   least must be seen; at most one in a thousand of the path's may still
   go missing). For a prefill and a decode step of granite-8b, its
   train step and rwkv6-3b's prefill, ``FlopCounterMode`` over the run on
   the card must equal, exactly, the FLOPs of the same program's dry run on
   a 1x1 mesh at the same shapes; the dry run's ``peak_per_device_bytes``
   is printed beside the run's ``max_memory_allocated``, and the measured
   step beside the roofline's step time of that 1x1 record, with the
   ``nvidia-smi`` line.

19. Rep 16 and the registry's last configs on the card. (a) llama3-405b
   (126 layers, d_model 16384, 128 heads over 8 KV heads) and
   qwen3-moe-235b-a22b (94 layers, 64 heads over 4, 128 experts top-8)
   served as 4-layer full-width cuts as phase 4 serves granite-8b (the
   weights drawn leaf by leaf and cast; skipped under ``--skip-serving``):
   9 RMSNorm + 4 flash-attention launches a prefill, 9 RMSNorm + 4
   flash-decode a decode step (288, 4 and 124 over the batch); prefill ms,
   decode ms a step, tokens/s, peak memory, the profile's busy share, and
   for the MoE each layer's dropped share. (b) The 2-layer cuts of both,
   of internvl2-76b (after 128 frame embeddings) and of deepseek-67b,
   kernels vs plain as phase 4's, with the heads control refused at every
   step. After it every config of the registry has run its kernels on the
   card against the plain path.

The last lines are the ``nvidia-smi`` name/power-limit line as it prints
it, one JSON object with every kernel's numbers, and ``{"ok": true,
"device": {...}}``. A kernel's ``launches`` is its count on the serving path
it was ported for (granite-8b for RMSNorm and both attention kernels,
rwkv6-3b for WKV6); ``launches_by_path`` gives each path's count, the
training paths' over their 3 steps, the fused path's over its 53, the
resume path's over its 11, the failure path's over its steps, the streams
path's over its 22, phase 13's host path's (none), phase 14's, 15's and
16's serving and training paths', phase 17's host path's (none) and
phase 19's serving paths'.
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# A kernel against its plain version. Each element must hold
#     |kernel - plain| <= KERNEL_RTOL * |plain| + c * RMS(plain's vector)
# where the RMS is over the last axis (one normed row, one head's attention
# output), so the limit follows each output's own scale: K3's outputs at
# cur_index 1015 average ~1016 unit-normal values and have an RMS near 0.05,
# and a fixed 4e-2 would pass a wrong split, combine or tail mask there.
# KERNEL_RTOL is one bf16 ulp of the value (both versions round the output
# to bf16 once). c covers the rest: K2, K3 and K4's y compute in fp32
# throughout (1%); K1 feeds P to the tensor cores in bf16 while its plain version keeps
# P in fp32, which adds noise of ~2**-9 of the output's scale per element,
# up to ~0.7% at the largest of 32 M elements (2%).
KERNEL_RTOL = 2.0 ** -7
# WKV6's fp32 state, kernel against plain (both chunked, 64 tokens): rtol =
# c = 1e-3 of the row's RMS. Both carry the decay as exp of differences of
# fp32 cumulative log sums that reach ~-1800 over a chunk (log w is clamped
# at log 1e-12 = -27.6), whose rounding is ~1e-4 of a decay factor; the
# kernel's state product is 3xTF32 (near fp32); the rest is fp32 summation
# over at most 1000 steps.
WKV_STATE_TOL = 1e-3
KERNEL_ATOL_OF_RMS = {"rmsnorm": 1e-2, "decode_attention": 1e-2,
                      "flash_attention": 2e-2, "wkv6": 1e-2}
# The 2-layer logits, kernel path against plain path, end to end through
# bf16 weight products: atol = rtol, the bf16 tolerance of
# tests/test_kernels.py:20-22 (the logits' RMS is printed beside it).
E2E_TOL = 4e-2
HBM_BYTES_PER_S = 3.35e12    # H100 SXM data sheet
BF16_TENSOR_FLOPS = 989e12   # dense bf16 tensor-core peak
FP32_FLOPS = 67e12           # fp32 outside the tensor cores
TF32_FLOPS = 495e12          # dense TF32 tensor-core peak
# ~0.5 ms of the card's clock (1.98 GHz at most) before each timed launch:
# without it a host call slower than the ~80 us flush put host time
# inside the events, a decode kernel's median reading up to 2x its own
SPIN_CYCLES = 1_000_000
# spin kernels that open each profile: the tracer drops a session's first
# device events, a few dozen at most over this script's run
TRACER_MARKERS = 256

# the serving runs of phases 4 and 5
BATCH, PROMPT, NEW_TOKENS = 8, 1000, 32
MAX_SEQ = PROMPT + NEW_TOKENS
SEED = 0
# rwkv6-3b's WKV shape: d_model 2560 / head_dim 64, and its rwkv_chunk
RWKV_HEADS, RWKV_CHUNK = 40, 64
WKV_CHUNK = 64  # the K4 kernel's own chunk (csrc/wkv6.cu kC)

# the training runs of phases 6-8
TRAIN_GB, TRAIN_SEQ, TRAIN_STEPS = 4, 1024, 3
GRANITE_TRAIN_LAYERS = 8  # of 36: 16 B a parameter of fp32 state must fit 80 GB
RWKV_TRAIN_LAYERS = 32    # all of them
TRAIN_OPT = dict(learning_rate=1e-4, warmup_steps=1, total_steps=10)
# Phase 8's bounds, kernel path against plain path. The backward rules but
# K4's are the same plain functions on both paths, so the gradients differ
# through the forward kernels' outputs and K4's backward kernel (near fp32:
# 3xTF32 products); the forward 2-layer cuts read RMS(diff) / RMS(plain)
# 0.005-0.009, so 5e-2 leaves about 5x.
TRAIN_LOSS_RTOL = 1e-3
GRAD_RMS_TOL = 5e-2
GRAD_NORM_RTOL = 1e-2
# phase 9: fig17's three arms (benchmarks/fig17_fused_train.py), the
# granite-8b cut of phase 6 with 4 x 1024 tokens a step over dp 2 x cp 2
FUSED_DP, FUSED_CP = 2, 2
FUSED_BATCHES = 14            # the stream of tests/test_fused_train.py:50-52
FUSED_WARMUP, FUSED_TIMED = 2, 6
FUSED_PROFILED = 2            # the tgb depth-2 arm's steps under torch.profiler
FIG17_DEPTHS = (0, 2)
FIG17_BACKENDS = ("colocated", "mq", "tgb")   # fig17's order at each depth
COLOC_COST_S = 0.0002         # fig17's preprocessing seconds a sample
# benchmarks/check_fig17.py's gates, on the tgb arm at depth 2
FIG17_MAX_DATA_WAIT = 0.15    # data_wait share of the step
FIG17_VS_COLOCATED = 0.9      # tokens/s against the colocated arm's
FIG17_VS_DEPTH0 = 1.15        # tokens/s against its own depth-0 arm's ...
FIG17_WAIT_DROP = 0.1         # ... whose data_wait share is this much higher
FIG17_ROOFLINE_SPREAD = 2.5   # compute_vs_roofline flat across arms
# phase 10: phase 9's settings through a TrainSession, an aligned checkpoint,
# a kill between a later upload and its commit, and the resume
RESUME_NS = "runs/resume"
# the resumed steps' losses against the uninterrupted run's: the rtol of the
# reference's kill-and-resume test (tests/test_fused_train.py:115-116); the
# same state, batches and kernels should give bit-equal losses
RESUME_LOSS_RTOL = 1e-6
# phase 11: failure isolation and a brownout, on the cut of phase 9 at depth 2
FAILURE_STEPS = 12            # of the FUSED_BATCHES-batch stream
CRASH_AFTER_STEP = 3          # (a) the colocated pool dies after this step
CRASH_TIMEOUT_S = 5.0         # (a) the loop's timeout
KILL_AFTER_TGBS = 5           # (b) the tgb producer dies before this TGB
PRODUCE_DELAY_S = 0.2         # (b, c) the live producer's seconds a TGB
RESTART_S = 1.0               # (b) seconds until the replacement writer enters
BROWNOUT_WARMUP_TGBS = 4      # (c) TGBs committed before the run
OBS_SNAP_S = 0.5              # (c) the flight recorder's interval
# phase 12: the granite cut of phase 9 fed by a weighted mix of a raw stream,
# a stream sharded into CODE_SHARDS manifest chains (folded by the compactor)
# and a stream derived live from the raw one, checkpointed and resumed
# through a composite cursor
STREAMS_NS = "runs/streams"
STREAM_WEIGHTS = {"web": 0.5, "code": 0.3, "filtered": 0.2}
MIX_SEED = 11
STREAM_STEPS = 14             # run A's steps
STREAM_CKPT_STEP = 6          # run A's aligned checkpoint; run B replays the rest
STREAM_LOOKAHEAD = 4          # steps of data beyond the last one (the ring's reach)
STREAM_CP = 1                 # the derive worker decodes whole rows only at cp 1
CODE_SHARDS = 4
DERIVE_WINDOW = 2             # source TGBs a derive window
DERIVE_RESTART_S = 0.5        # seconds from the worker's kill to its replacement
# phase 13: the chaos harness and the operator CLI's entry points, host code
CHAOS_SEEDS = (0, 1)
CHAOS_SCENARIOS = (           # src/repro_torch/chaos/scenarios.py's registry
    "brownout_throttle_storm", "compactor_midfold_kill", "consumer_midstep_kill",
    "cput_conflict_storm", "derive_worker_midpublish_kill", "flaky_reads",
    "mixed_reader_midstep_kill", "producer_kill_obs_postmortem", "producer_post_upload_kill",
    "producer_precommit_kill", "reclaimer_midtrim_kill", "shard_conflict_storm",
    "store_outage_resume", "trainer_midcheckpoint_kill")
HOST_TIMEOUT_S = 300          # a subprocess of phase 13
# phase 17: each data-plane example of the port and lines its story must
# hold: the reference's counts of batches, steps, offsets and TGBs. Where a
# writer commits on the DAC's cadence, which follows the wall clock, the
# number of manifest versions moves with the host's load, and with it the
# versions in a cursor and the bytes a reclaim frees: none of those is
# pinned
EXAMPLE_STORIES = {
    "quickstart": ("6 global batches, producer offsets={'worker0': 2, 'worker1': 2}",
                   "consumed 6 steps", "reclaimed 6 TGBs (",
                   "worker0 replacement resumes at stream offset 3"),
    "failover": ("committed through offset 2 (3 steps visible)",
                 "replacement resumed at offset 3; stream is dense: [0, 1, 2, 3]...[8, 9]",
                 "RunManifest seq 0 @ step 4", "resumed at step 4",
                 "reclaimer deleted 4 TGBs below the aligned checkpoint",
                 "OK: exactly-once + aligned model/data recovery + reclamation all hold"),
    "sft_mixture": ("published per stream: {'code': 6, 'math-sft': 2, 'web': 12}",
                    "12 mixed steps consumed: {'code': 4, 'math-sft': 1, 'web': 7}",
                    "composite cursor: step=12", "reclaimed 12 TGBs across streams",
                    "resumed and drained to global step 20"),
}
# phase 14: the MoE family and the vision prefix. deepseek-moe-16b serves at
# full width and depth with phase 4's settings; qwen3-vl-30b-a3b trains as a
# full-width cut (all 48 layers' fp32 state would take 489 GB) on phase 6's
# batch after a prefix of frame embeddings, the reference's
# max(16, min(256, S // 8)) positions (src/repro/train/step.py:51-52)
VL_TRAIN_LAYERS = 4           # of 48: 3.115 B parameters, 46.4 GiB of fp32 state
VL_PREFIX = max(16, min(256, TRAIN_SEQ // 8))
# phase 15: the Mamba2 / Zamba2 hybrid. zamba2-7b serves at full width and
# depth with phase 4's settings; its full-width cut of one group of 6
# Mamba2 layers and the shared block, then one tail layer, trains on phase
# 6's batch (all 81 layers' fp32 state would take 108 GB)
HYBRID_TRAIN_LAYERS = 7       # of 81: 0.981 B parameters, 15.7 GB of fp32 state
# phase 16: the audio family. musicgen-medium serves BATCH prompts of PROMPT
# frames of 4 codebooks after a conditioning prefix of AUDIO_PREFIX frame
# embeddings, into a cache of AUDIO_PREFIX + MAX_SEQ positions, and trains
# at full depth (1.837 B parameters, 29.4 GB of fp32 state) on phase 6's
# batch after the same prefix (the reference's max(16, min(256, S // 8)) at
# S 1024); qwen1.5-32b, the first config with a QKV bias, runs as a 2-layer
# full-width cut
AUDIO_PREFIX = 128
AUDIO_TRAIN_LAYERS = 48       # all of them
# phase 18: the dry run's named cells (arch, shape), each on both
# production meshes, and the seconds a cell's subprocess may take
DRYRUN_CELLS = (("granite_8b", "train_4k"), ("deepseek_moe_16b", "train_4k"),
                ("zamba2_7b", "long_500k"), ("llama3_405b", "train_4k"),
                ("llama3_405b", "decode_32k"))
DRYRUN_TIMEOUT_S = 400
# phase 19: rep 16. llama3-405b (3.19 B parameters a layer, 2 x 2.10 B of
# untied tables) and qwen3-moe-235b-a22b (2.49 B a layer, 2 x 0.62 B) serve
# as full-width cuts with phase 4's settings: llama3-405b's 4 layers are
# 34 GB in bf16, beside a transient fp32 FFN leaf of (4, 16384, 53248),
# 14.0 GB, while it is drawn (8 layers would not fit); internvl2-76b's
# 2-layer cut reads VLM_PREFIX frame embeddings first, as qwen3-vl's does
LARGE_SERVE_LAYERS = 4
VLM_PREFIX = 128
DRYRUN_OUT = ROOT / "build" / "dryrun"
# the forward kernels' names as the profiler lists them
KERNEL_SYMBOLS = {"rmsnorm": "rmsnorm_kernel", "flash_attention": "fa_fwd_kernel",
                  "decode_attention": "decode_kernel", "wkv6": "wkv6_kernel",
                  "wkv6_bwd": "wkv6_bwd_chunks", "adamw": "adamw_"}


def log(*a):
    print(*a, flush=True)


def top_and_obs(store, namespace):
    """``top`` and ``obs --json`` over ``namespace``, from storage alone:
    (top's text, obs's rows by component, each command's ms)."""
    rc_top, top, top_ms = run_ops(store, namespace, "top")
    rc_obs, obs, obs_ms = run_ops(store, namespace, "--json", "obs")
    if rc_top != 0 or rc_obs != 0:
        raise AssertionError(f"top / obs over {namespace} exited {rc_top} / {rc_obs}")
    rows = {r["component"]: r for r in json.loads(obs)["components"]}
    return top, rows, (top_ms, obs_ms)


def postmortem(store, namespace, killed, replacement) -> str:
    """The operator's post-mortem of a killed producer from storage alone
    (``producer_kill_obs_postmortem`` of ``repro_torch.chaos``): ``top``
    renders the killed incarnation, component ``killed``, with work in its
    last snapshot, and its replacement, ``replacement``, as another
    incarnation; each component's rate window holds one incarnation, so no
    rate is taken across the two. Returns what it saw; raises if not."""
    from repro_torch.core import Namespace
    from repro_torch.obs.recorder import read_snapshots

    top, rows, cli_ms = top_and_obs(store, namespace)
    dead, repl = rows.get(killed), rows.get(replacement)
    incs = {c: sorted({s["inc"] for s in read_snapshots(Namespace(store, namespace), c, last=8)})
            for c in (killed, replacement)}
    top_rows = [line.strip() for line in top.splitlines() if line.strip().startswith("producer.")]
    if killed not in top or replacement not in top or dead is None or repl is None \
            or dead["metrics"].get("tgbs_written", 0) < 1 or dead["inc"] == repl["inc"] \
            or incs != {killed: [dead["inc"]], replacement: [repl["inc"]]}:
        raise AssertionError(f"top over {namespace} does not render the killed producer "
                             f"{killed} and its replacement {replacement} as two "
                             f"incarnations: {top_rows}, {incs}")
    return (f"top over {namespace} after the kill ({cli_ms[0]:.1f} ms; obs --json "
            f"{cli_ms[1]:.1f} ms): {top_rows}; the killed incarnation {killed} (inc "
            f"{dead['inc']}, {dead['snaps']} snapshots, last tgbs_written "
            f"{dead['metrics'].get('tgbs_written')}, rates "
            f"{ {k: round(v, 2) for k, v in dead['rates'].items() if 'tgbs' in k} }), the "
            f"replacement {replacement} (inc {repl['inc']}, {repl['snaps']} snapshots, "
            f"tgbs_written {repl['metrics'].get('tgbs_written')}); incarnations in each rate "
            f"window {incs}")


def store_row_from_storage(inner, namespace, resilient):
    """``top`` and ``obs --json`` over ``namespace`` on ``inner``, the store
    under the ResilientStore ``resilient``, once that wrapper's last word
    is in storage (the recorder snaps on its heartbeat, and never retries a
    snapshot the storm shed): (top's text, its ``store.*`` row, ms)."""
    from repro_torch.core import Namespace
    from repro_torch.obs.recorder import latest_snapshot

    rs = resilient.resilience
    snap = latest_snapshot(Namespace(inner, namespace), rs.metric_scope)
    if snap is None or snap["metrics"].get(f"{rs.metric_scope}.throttled") != rs.throttled:
        resilient._recorder.snap()
    top, rows, cli_ms = top_and_obs(inner, namespace)
    return top, rows.get(rs.metric_scope) or {"metrics": {}}, cli_ms


def run_ops(store, namespace, *args):
    """``python -m repro_torch.ops`` in process over ``store`` (its
    ``--root`` is not read when a store is given): (exit code, output, ms)."""
    from repro_torch.ops import main as ops_main

    out = io.StringIO()
    t0 = time.perf_counter()
    rc = ops_main(["--root", "-", "-n", namespace, *args], store=store, out=out)
    return rc, out.getvalue(), (time.perf_counter() - t0) * 1e3


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(torch, fn, flush, iters: int, warmup: int = 3) -> float:
    """Median per-launch device time of ``fn`` over ``iters`` launches, each
    preceded (outside the timed window) by a write that evicts the L2 and
    a spin of the card that outlasts the host's call of ``fn``, so the
    start event fires only once the launch is queued behind it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def host_us(torch, fn, iters: int = 2000) -> float:
    """Mean wall time of one call of ``fn`` in a loop of ``iters`` calls, in
    microseconds: the host's cost per call where the kernel is shorter than
    the launch."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e6


def bound(nbytes: float, flops: float, peak_flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def share_of_limit(torch, name, got, want, rtol=KERNEL_RTOL, c=None):
    """(max |err|, the worst element's |err| as a share of its limit
    rtol |want| + c RMS); ``name`` starts with the kernel's name, which
    gives c unless it is passed."""
    g, w = got.float(), want.float()
    if got.shape != want.shape or not torch.isfinite(g).all():
        raise AssertionError(f"{name}: shape {tuple(got.shape)} or non-finite output")
    err = (g - w).abs()
    rms = w.pow(2).mean(dim=-1, keepdim=True).sqrt()
    if c is None:
        c = KERNEL_ATOL_OF_RMS[name.split()[0]]
    limit = rtol * w.abs() + c * rms
    return float(err.max()), float((err / limit.clamp_min(1e-30)).max())


def check_kernel(torch, name, got, want, **tol):
    """Kernel output against its plain version: (max |err|, share)."""
    err, share = share_of_limit(torch, name, got, want, **tol)
    if share > 1.0:
        raise AssertionError(f"{name}: max |err| {err:.3e}, worst "
                             f"element at {share:.2f}x its limit")
    return err, share


def check_rejects(torch, name, got, want, **tol) -> float:
    """A negative control: ``got`` carries a deliberate one-key fault, and
    the kernel check must refuse it. Returns the worst share of the limit."""
    _, share = share_of_limit(torch, name, got, want, **tol)
    if share <= 1.0:
        raise AssertionError(f"{name}: the kernel check let a one-key fault "
                             f"through ({share:.2f} of its limit)")
    log(f"  control {name}: refused, worst element at {share:.2f}x its limit")
    return share


def read_close(torch, name, got, want, tol=E2E_TOL):
    """``allclose(atol = rtol = tol)`` read, not yet enforced: returns (max
    |err|, the worst element's |err| as a share of its limit tol + tol
    |want|, RMS of the difference over RMS of ``want``, whether allclose
    holds)."""
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        raise AssertionError(f"{name}: non-finite output")
    diff = g - w
    err = float(diff.abs().max())
    share = float((diff.abs() / (tol + tol * w.abs())).max())
    rel_rms = float(diff.pow(2).mean().sqrt() / w.pow(2).mean().sqrt().clamp_min(1e-30))
    return err, share, rel_rms, bool(torch.allclose(g, w, atol=tol, rtol=tol))


# label -> K1's output in phase 3, kept when --save asks for them
K1_OUTPUTS = None


def compare_saved(torch, files) -> int:
    """Print whether K1's outputs saved by ``--save`` in ``files`` (runs of
    this harness, one tree's kernels each) are bit-identical label by
    label; 0 if every label is."""
    outs = [torch.load(f) for f in files]
    same = {label: all(label in o and torch.equal(outs[0][label], o[label])
                       for o in outs[1:]) for label in outs[0]}
    log(json.dumps({"k1_bit_identical": same, "files": list(files)}))
    return 0 if all(same.values()) else 1


def phase_kernels(torch, F, flush, names):
    """Each named kernel against its plain version; returns the JSON
    entries."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    entries = {}
    for name in names:
        KERNEL_PHASES[name](torch, F, flush, randn, entries)
    return entries


def kernel_rmsnorm(torch, F, flush, randn, entries):
    """K2 RMSNorm: granite-8b's D 4096, rwkv6-3b's D 2560, zamba2-7b's D
    3584 and its Mamba2 blocks' D 7168 (``out_norm`` over d_inner),
    musicgen-medium's D 1536 (its prefill rows count the conditioning
    prefix) and qwen1.5-32b's D 5120, at the serving and the training rows.
    Timed through the launcher ``rmsnorm_fwd``."""
    from repro_torch.kernels.rmsnorm.ops import rmsnorm, rmsnorm_fwd
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

    train_rows = TRAIN_GB * TRAIN_SEQ
    for label, rows, dim in (("prefill", BATCH * PROMPT, 4096), ("decode", BATCH, 4096),
                             ("ragged", 1001, 4096), ("rwkv prefill", BATCH * PROMPT, 2560),
                             ("rwkv decode", BATCH, 2560), ("tiny", 3, 64),
                             ("train", train_rows, 4096), ("rwkv train", train_rows, 2560),
                             ("moe prefill", BATCH * PROMPT, 2048),
                             ("vl train", TRAIN_GB * (TRAIN_SEQ + VL_PREFIX), 2048),
                             ("hybrid prefill", BATCH * PROMPT, 3584),
                             ("hybrid out_norm", BATCH * PROMPT, 7168),
                             ("hybrid decode", BATCH, 3584),
                             ("hybrid decode out_norm", BATCH, 7168),
                             ("hybrid train out_norm", train_rows, 7168),
                             ("audio prefill", BATCH * (AUDIO_PREFIX + PROMPT), 1536),
                             ("audio decode", BATCH, 1536),
                             ("audio train", TRAIN_GB * (TRAIN_SEQ + AUDIO_PREFIX), 1536),
                             ("qwen prefill", BATCH * PROMPT, 5120),
                             ("qwen decode", BATCH, 5120),
                             ("llama prefill", BATCH * PROMPT, 16384),
                             ("llama decode", BATCH, 16384)):
        x, w = randn(rows, dim), randn(dim, dtype=torch.float32)
        err, share = check_kernel(torch, f"rmsnorm {label}", rmsnorm(x, w),
                                  rmsnorm_ref(x, w))
        line = f"rmsnorm {label} ({rows}, {dim}): max|err| {err:.3e} ({share:.2f} of limit)"
        if label in ("hybrid out_norm", "llama decode"):
            rmsnorm_given_mean_square(torch, flush, x, w, label, entries)
        if label in ("prefill", "decode", "rwkv prefill", "hybrid prefill",
                     "hybrid out_norm", "audio prefill", "qwen prefill", "llama prefill"):
            ms = time_ms(torch, lambda: rmsnorm_fwd(x, w), flush, 50)
            plain = time_ms(torch, lambda: rmsnorm_ref(x, w), flush, 20)
            wb = w.to(x.dtype)
            lib = time_ms(torch, lambda: F.rms_norm(x, (dim,), wb, 1e-5), flush, 50)
            nbytes = 2 * x.numel() * x.element_size() + w.numel() * 4
            b_ms, b_by = bound(nbytes, 4.0 * x.numel(), FP32_FLOPS)
            line += (f"  kernel {ms:.4f} ms  plain {plain:.4f} ms  "
                     f"F.rms_norm {lib:.4f} ms  bound {b_ms:.4f} ms ({b_by})")
            if label == "prefill":
                entries["rmsnorm"] = dict(
                    name="rmsnorm", route="cuda", source="src/repro_torch/csrc/rmsnorm.cu",
                    replaces="src/repro/kernels/rmsnorm/kernel.py:20",
                    shape=f"x ({rows}, {dim}) bf16", max_abs_err=err,
                    max_err_share_of_limit=share, ms=ms,
                    plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib)
            else:
                key = label.replace(" ", "_")
                entries["rmsnorm"][key + "_shape_ms"] = ms
                if label == "decode":  # what the autograd Function adds a call
                    fn_us = host_us(torch, lambda: rmsnorm(x, w))
                    bare_us = host_us(torch, lambda: rmsnorm_fwd(x, w))
                    line += (f"  host a call: through the Function {fn_us:.2f} us, "
                             f"the launcher alone {bare_us:.2f} us")
                    entries["rmsnorm"].update(decode_host_us_function=fn_us,
                                              decode_host_us_launcher=bare_us)
                else:
                    entries["rmsnorm"].update({key + "_library_ms": lib,
                                               key + "_bound_ms": b_ms,
                                               key + "_plain_ms": plain})
        log(line)


def rmsnorm_given_mean_square(torch, flush, x, w, label, entries):
    """K2 handed each row's own mean square (the form a row sharded across
    devices takes, its sum of squares all-reduced) against K2 without it
    and the plain version; four times the mean square is the control."""
    from repro_torch.kernels.rmsnorm.ops import rmsnorm_fwd
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

    ms = x.float().pow(2).mean(-1)
    got = rmsnorm_fwd(x, w, 1e-5, ms)
    err, share = check_kernel(torch, f"rmsnorm {label}, mean square given", got,
                              rmsnorm_ref(x, w))
    own, own_share = check_kernel(torch, f"rmsnorm {label}, mean square given, vs K2",
                                  got, rmsnorm_fwd(x, w))
    ms_ms = time_ms(torch, lambda: rmsnorm_fwd(x, w, 1e-5, ms), flush, 50)
    log(f"rmsnorm {label} {tuple(x.shape)} with each row's mean square given: max|err| "
        f"{err:.3e} ({share:.2f} of limit) vs plain, {own:.3e} ({own_share:.2f}) vs K2 "
        f"without it; kernel {ms_ms:.4f} ms")
    check_rejects(torch, f"rmsnorm {label}, four times the mean square given",
                  rmsnorm_fwd(x, w, 1e-5, 4 * ms), rmsnorm_ref(x, w))
    entries["rmsnorm"].setdefault("given_mean_square", {})[label.replace(" ", "_")] = dict(
        max_abs_err=err, max_err_share_of_limit=share, vs_k2_max_abs_err=own, ms=ms_ms)


def kernel_flash_attention(torch, F, flush, randn, entries):
    """K1 flash attention at granite-8b's prefill and training shapes,
    deepseek-moe-16b's prefill (rep 1), qwen3-vl-30b-a3b's training
    sequence after its prefix (rep 8), zamba2-7b's prefill and training
    shapes (head_dim 112, rep 1), musicgen-medium's prefill and training
    sequences after its conditioning prefix (head_dim 64, rep 1, 24 heads)
    and qwen1.5-32b's prefill (40 heads, rep 1). Timed through the launcher
    ``flash_attention_fwd``."""
    from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                         flash_attention_fwd)
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    for label, (B, S, H, G, dh, causal) in (
            ("prefill", (BATCH, PROMPT, 32, 8, 128, True)),
            ("train", (TRAIN_GB, TRAIN_SEQ, 32, 8, 128, True)),
            ("moe prefill", (BATCH, PROMPT, 16, 16, 128, True)),
            ("vl train", (TRAIN_GB, TRAIN_SEQ + VL_PREFIX, 32, 4, 128, True)),
            ("hybrid prefill", (BATCH, PROMPT, 32, 32, 112, True)),
            ("hybrid train", (TRAIN_GB, TRAIN_SEQ, 32, 32, 112, True)),
            ("hybrid ragged", (2, 45, 4, 4, 112, True)),
            ("audio prefill", (BATCH, AUDIO_PREFIX + PROMPT, 24, 24, 64, True)),
            ("audio train", (TRAIN_GB, TRAIN_SEQ + AUDIO_PREFIX, 24, 24, 64, True)),
            ("audio ragged", (2, 45, 24, 24, 64, True)),
            ("qwen prefill", (BATCH, PROMPT, 40, 40, 128, True)),
            ("llama prefill", (BATCH, PROMPT, 128, 8, 128, True)),
            ("rep16 ragged", (2, 45, 16, 1, 64, True)),
            ("ragged", (2, 45, 4, 2, 128, True)),
            ("full", (2, 100, 6, 3, 64, False)),
            ("tiny", (1, 5, 2, 1, 64, True))):
        q, k, v = randn(B, S, H, dh), randn(B, S, G, dh), randn(B, S, G, dh)
        got = flash_attention(q, k, v, causal)
        if K1_OUTPUTS is not None:
            K1_OUTPUTS[label] = got.cpu()
        err, share = check_kernel(torch, f"flash_attention {label}", got,
                                  flash_attention_ref(q, k, v, causal))
        del got
        line = (f"flash_attention {label} q{(B, S, H, dh)} kv{(B, S, G, dh)}: "
                f"max|err| {err:.3e} ({share:.2f} of limit)")
        if label in ("prefill", "moe prefill", "hybrid prefill", "audio prefill",
                     "llama prefill"):
            ms = time_ms(torch, lambda: flash_attention_fwd(q, k, v, causal), flush, 20)
            plain = time_ms(torch, lambda: flash_attention_ref(q, k, v, causal), flush, 5)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True), flush, 20)
            nbytes = (2 * q.numel() + k.numel() + v.numel()) * 2  # q, k, v in; o out
            pairs = S * (S + 1) // 2 if causal else S * S
            flops = 4.0 * dh * pairs * B * H
            b_ms, b_by = bound(nbytes, flops, BF16_TENSOR_FLOPS)
            line += (f"  kernel {ms:.4f} ms  plain {plain:.4f} ms  sdpa {lib:.4f} ms  "
                     f"bound {b_ms:.4f} ms ({b_by}, {flops / 1e9:.1f} GFLOP)")
            if label == "prefill":
                entries["flash_attention"] = dict(
                    name="flash_attention", route="cuda",
                    source="src/repro_torch/csrc/flash_attention.cu",
                    replaces="src/repro/kernels/flash_attention/kernel.py:29",
                    shape=f"q ({B}, {S}, {H}, {dh}) kv ({B}, {S}, {G}, {dh}) bf16 causal",
                    max_abs_err=err, max_err_share_of_limit=share, ms=ms,
                    plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib)
            else:  # deepseek-moe-16b's, zamba2-7b's, musicgen-medium's, beside granite-8b's
                key = label.replace(" ", "_")
                entries["flash_attention"].update({
                    f"{key}_shape": f"q ({B}, {S}, {H}, {dh}) kv ({B}, {S}, {G}, {dh})",
                    f"{key}_ms": ms, f"{key}_plain_ms": plain, f"{key}_library_ms": lib,
                    f"{key}_bound_ms": b_ms, f"{key}_bound_by": b_by,
                    f"{key}_max_abs_err": err, f"{key}_max_err_share_of_limit": share})
        log(line)
        if label in ("prefill", "hybrid prefill", "audio prefill", "llama prefill"):
            # one key's value lost: only the last row sees it
            v_bad = v.clone()
            v_bad[:, -1] = 0
            check_rejects(torch, f"flash_attention {label}, last key's value zeroed",
                          flash_attention(q, k, v_bad, causal),
                          flash_attention_ref(q, k, v, causal))


def kernel_decode_attention(torch, F, flush, randn, entries):
    """K3 flash decode at granite-8b's, deepseek-moe-16b's (rep 1),
    zamba2-7b's (rep 1, head_dim 112), musicgen-medium's (rep 1, head_dim
    64, 24 heads, over its prefix, prompt and new frames), qwen1.5-32b's
    (40 heads, rep 1), llama3-405b's and qwen3-moe-235b-a22b's (rep 16),
    and deepseek-67b's and qwen3-vl-30b-a3b's (rep 8; internvl2-76b's is
    deepseek-67b's) decode shapes; reps 8 and 16 run the tensor-core form."""
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref

    cur_main = PROMPT + NEW_TOKENS // 2 - 1
    for label, (B, H, G, dh, T, cur) in (
            ("decode", (BATCH, 32, 8, 128, MAX_SEQ, cur_main)),
            ("tail", (BATCH, 32, 8, 128, MAX_SEQ, MAX_SEQ - 1)),
            ("moe decode", (BATCH, 16, 16, 128, MAX_SEQ, cur_main)),
            ("moe tail", (BATCH, 16, 16, 128, MAX_SEQ, MAX_SEQ - 1)),
            ("hybrid decode", (BATCH, 32, 32, 112, MAX_SEQ, cur_main)),
            ("hybrid tail", (BATCH, 32, 32, 112, MAX_SEQ, MAX_SEQ - 1)),
            ("hybrid ragged", (3, 6, 3, 112, 100, 70)),
            ("audio decode", (BATCH, 24, 24, 64, AUDIO_PREFIX + MAX_SEQ,
                              AUDIO_PREFIX + PROMPT - 1)),
            ("audio tail", (BATCH, 24, 24, 64, AUDIO_PREFIX + MAX_SEQ,
                            AUDIO_PREFIX + MAX_SEQ - 1)),
            ("qwen decode", (BATCH, 40, 40, 128, MAX_SEQ, cur_main)),
            ("llama decode", (BATCH, 128, 8, 128, MAX_SEQ, cur_main)),
            ("llama tail", (BATCH, 128, 8, 128, MAX_SEQ, MAX_SEQ - 1)),
            ("qwen3moe decode", (BATCH, 64, 4, 128, MAX_SEQ, cur_main)),
            ("deepseek67b decode", (BATCH, 64, 8, 128, MAX_SEQ, cur_main)),
            ("qwen3vl decode", (BATCH, 32, 4, 128, MAX_SEQ, cur_main)),
            ("rep8 tail", (BATCH, 32, 4, 128, MAX_SEQ, MAX_SEQ - 1)),
            ("rep16 dh64", (3, 32, 2, 64, 300, 299)),
            ("rep16 dh112", (3, 32, 2, 112, 300, 150)),
            ("ragged", (3, 6, 3, 64, 100, 70)),
            ("tiny", (1, 8, 1, 64, 5, 0))):
        q, kc, vc = randn(B, H, dh), randn(B, T, G, dh), randn(B, T, G, dh)
        err, share = check_kernel(torch, f"decode_attention {label}",
                                  decode_attention(q, kc, vc, cur),
                                  decode_attention_ref(q, kc, vc, cur))
        line = (f"decode_attention {label} q{(B, H, dh)} cache{(B, T, G, dh)} cur {cur}: "
                f"max|err| {err:.3e} ({share:.2f} of limit)")
        if label in ("decode", "moe decode", "hybrid decode", "audio decode",
                     "llama decode", "qwen3moe decode", "deepseek67b decode",
                     "qwen3vl decode"):
            ms = time_ms(torch, lambda: decode_attention(q, kc, vc, cur), flush, 50)
            plain = time_ms(torch, lambda: decode_attention_ref(q, kc, vc, cur), flush, 20)
            qs = q[:, :, None]
            ks, vs = (t[:, :cur + 1].transpose(1, 2) for t in (kc, vc))
            lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
                qs, ks, vs, enable_gqa=True), flush, 50)
            n = cur + 1
            nbytes = 2 * B * n * G * dh * 2 + 2 * q.numel() * 2
            flops = 4.0 * B * H * n * dh
            b_ms, b_by = bound(nbytes, flops, FP32_FLOPS)
            line += (f"  kernel {ms:.4f} ms  plain {plain:.4f} ms  sdpa {lib:.4f} ms  "
                     f"bound {b_ms:.4f} ms ({b_by}, {nbytes / 1e6:.1f} MB)")
            if label == "decode":
                entries["decode_attention"] = dict(
                    name="decode_attention", route="cuda",
                    source="src/repro_torch/csrc/decode_attention.cu",
                    replaces="src/repro/kernels/decode_attention/kernel.py:34",
                    shape=f"q ({B}, {H}, {dh}) cache ({B}, {T}, {G}, {dh}) bf16 cur_index {cur}",
                    max_abs_err=err, max_err_share_of_limit=share, ms=ms,
                    plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib)
            else:  # deepseek-moe-16b's, zamba2-7b's, musicgen-medium's, beside granite-8b's
                key = label.replace(" ", "_")
                entries["decode_attention"].update({
                    f"{key}_shape": f"q ({B}, {H}, {dh}) cache ({B}, {T}, {G}, {dh})",
                    f"{key}_ms": ms, f"{key}_plain_ms": plain, f"{key}_library_ms": lib,
                    f"{key}_bound_ms": b_ms, f"{key}_bound_by": b_by,
                    f"{key}_max_abs_err": err, f"{key}_max_err_share_of_limit": share})
        log(line)
        if label in ("decode", "hybrid decode", "audio decode", "llama decode",
                     "qwen3moe decode", "deepseek67b decode", "qwen3vl decode"):
            # the newest key left out of the kernel's range
            check_rejects(torch, f"decode_attention {label}, newest key dropped",
                          decode_attention(q, kc, vc, cur - 1),
                          decode_attention_ref(q, kc, vc, cur))
        if label in ("decode", "llama decode"):
            decode_partial_check(torch, label, q, kc, vc, cur, entries)


def decode_partial_check(torch, label, q, kc, vc, cur, entries):
    """K3's partial form over the cache cut into 4 position pieces (the last
    past ``cur``: n_valid 0, no launch), combined as the sharded decode
    combines them (``combine_partials``), against K3 over the whole cache
    and the plain version. Each piece's output is rounded to bf16 before the
    combine, so the limit takes two ulps of the value. The control leaves
    the second piece out of the combine."""
    from repro_torch.kernels import common as kcommon
    from repro_torch.kernels.decode_attention.ops import (decode_attention,
                                                          decode_attention_partial)
    from repro_torch.kernels.decode_attention.ref import (combine_partials,
                                                          decode_attention_ref)

    T = kc.shape[1]
    bounds = [0, T // 4, T // 2, cur + 5, T]
    outs, lses = [], []
    before = kcommon.launches["decode_attention"]
    for a, b in zip(bounds, bounds[1:]):
        kp, vp = kc[:, a:b].contiguous(), vc[:, a:b].contiguous()
        o, lse = decode_attention_partial(q, kp, vp, min(max(cur + 1 - a, 0), b - a))
        outs.append(o)
        lses.append(lse)
    launched = kcommon.launches["decode_attention"] - before
    if launched != 3 or not bool(torch.isneginf(lses[-1]).all()) or bool(outs[-1].any()):
        raise AssertionError(f"decode_attention partial {label}: {launched} launches for "
                             f"3 non-empty pieces, or the empty piece not (0, -inf)")
    got = combine_partials(outs, lses)
    tol = dict(rtol=2 * KERNEL_RTOL)
    err, share = check_kernel(torch, f"decode_attention partial {label} vs plain", got,
                              decode_attention_ref(q, kc, vc, cur), **tol)
    werr, wshare = check_kernel(torch, f"decode_attention partial {label} vs whole", got,
                                decode_attention(q, kc, vc, cur), **tol)
    H, G = q.shape[1], kc.shape[2]
    log(f"decode_attention partial form, rep {H // G}, pieces {bounds}, cur {cur} (one empty): "
        f"combined vs plain max|err| {err:.3e} ({share:.2f} of limit), vs whole-cache K3 "
        f"{werr:.3e} ({wshare:.2f})")
    check_rejects(torch, f"decode_attention partial {label}, second piece left out",
                  combine_partials(outs[:1] + outs[2:], lses[:1] + lses[2:]),
                  decode_attention_ref(q, kc, vc, cur), **tol)
    entries["decode_attention"][f"partial_rep{H // G}_max_abs_err"] = err
    entries["decode_attention"][f"partial_rep{H // G}_max_err_share_of_limit"] = share


def wkv6_grad_shares(torch, got, want, w, r, k, rtol=KERNEL_RTOL, c=1e-2):
    """K4's backward against the plain rule, as the card tests hold it:
    {gradient: (max |err|, the worst element's share of its limit rtol
    |want| + c RMS of its row)}; dw as dw·w (the log-decay's cotangent,
    which both forms divide by w) with the RMS of the summands r·dr and
    k·dk in the absolute part, and exactly 0 wherever w < 1e-12."""
    def rms(x):
        return x.pow(2).mean(dim=-1, keepdim=True).sqrt()

    def share(g, wt, floor):
        if g.shape != wt.shape or not torch.isfinite(g).all():
            raise AssertionError("wkv6 backward: a shape differs or an output is non-finite")
        err = (g - wt).abs()
        return float(err.max()), float((err / (rtol * wt.abs() + c * floor)
                                        .clamp_min(1e-30)).max())

    dr, dk, dv, dw, du = (x.float() for x in got)
    pr, pk, pv, pw, pu = (x.float() for x in want)
    wf, rf, kf = w.float(), r.float(), k.float()
    if bool(dw[wf < 1e-12].any()) or bool(pw[wf < 1e-12].any()):
        raise AssertionError("wkv6 backward: dw is not 0 where w < 1e-12")
    return {"dr": share(dr, pr, rms(pr)), "dk": share(dk, pk, rms(pk)),
            "dv": share(dv, pv, rms(pv)),
            "dw": share(dw * wf, pw * wf, rms(pw * wf) + rms(rf * pr) + rms(kf * pk)),
            "du": share(du, pu, rms(pu))}


def kernel_wkv6_backward(torch, flush, randn, entries, r, k, v, w, u):
    """K4's backward at rwkv6-3b's training shape against the plain rule
    (checked, with a control: u zeroed), timed with L2 flushed beside its
    bound (r, k, v, w and the cotangent read, the four gradients written,
    u read and du written) and the plain rule's time."""
    from repro_torch.kernels.wkv6.ops import wkv6_bwd_kernel, wkv6_bwd_plain

    B, S, H, dh = r.shape
    g = randn(B, S, H, dh)
    got = wkv6_bwd_kernel(r, k, v, w, u, g)
    want = wkv6_bwd_plain(r, k, v, w, u, RWKV_CHUNK, g)
    shares = wkv6_grad_shares(torch, got, want, w, r, k)
    worst = max(sh for _, sh in shares.values())
    if worst > 1.0:
        raise AssertionError(f"wkv6 backward: {shares}")
    bad = wkv6_grad_shares(torch, wkv6_bwd_kernel(r, k, v, w, torch.zeros_like(u), g),
                           want, w, r, k)["dr"][1]
    if bad <= 1.0:
        raise AssertionError(f"wkv6 backward: the u-zeroed control passed ({bad:.2f})")
    log(f"  control wkv6 backward dr, u zeroed: refused, worst element at {bad:.2f}x its limit")
    ms = time_ms(torch, lambda: wkv6_bwd_kernel(r, k, v, w, u, g), flush, 20)
    plain = time_ms(torch, lambda: wkv6_bwd_plain(r, k, v, w, u, RWKV_CHUNK, g), flush, 5)
    nbytes = 9 * r.numel() * r.element_size() + 2 * u.numel() * 4
    # the chunked backward's products a chunk: the two state sweeps and the
    # inter-chunk and state terms of dv, dr, dk (2 C dh^2 each), dA, and A,
    # A^T gy and the intra-chunk terms of dr and dk over the lower triangle
    chunks = B * H * -(-S // WKV_CHUNK)
    flops = chunks * (10.0 * WKV_CHUNK * dh * dh + 5.0 * WKV_CHUNK ** 2 * dh)
    b_ms, b_by = bound(nbytes, flops, TF32_FLOPS)
    log(f"wkv6 backward r/k/v/w/gy{(B, S, H, dh)} bf16: "
        + ", ".join(f"{n} max|err| {e:.3e} ({sh:.2f} of limit)" for n, (e, sh) in shares.items())
        + f"  kernel {ms:.4f} ms  plain rule {plain:.4f} ms ({plain / ms:.1f}x)  bound "
        f"{b_ms:.4f} ms ({b_by}; {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP at TF32_FLOPS)"
        f"  share of bound {b_ms / ms:.1%}")
    entries["wkv6"]["backward"] = dict(
        source="src/repro_torch/csrc/wkv6.cu (wkv6_bwd)",
        shape=f"r/k/v/w/gy ({B}, {S}, {H}, {dh}) bf16, u ({H}, {dh}) fp32",
        max_err_share_of_limit={n: sh for n, (_, sh) in shares.items()},
        ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by)


def kernel_wkv6(torch, F, flush, randn, entries):
    """K4 WKV6 at rwkv6-3b's prefill and training shapes. Timed through the
    launcher ``wkv6_fwd``; then K4's backward at the training shape."""
    from repro_torch.kernels.wkv6.ops import wkv6, wkv6_fwd
    from repro_torch.kernels.wkv6.ref import wkv6_chunked

    for label, (B, S, H, dh) in (("prefill", (BATCH, PROMPT, RWKV_HEADS, 64)),
                                 ("train", (TRAIN_GB, TRAIN_SEQ, RWKV_HEADS, 64)),
                                 ("ragged", (3, 45, 5, 64)),
                                 ("one-token", (1, 1, 1, 64))):
        r, k, v = randn(B, S, H, dh), randn(B, S, H, dh), randn(B, S, H, dh)
        # the model's decay, exp(-exp(clip(., -8, 4))), rounded to bf16 as prefill does
        w = torch.exp(-torch.exp(randn(B, S, H, dh, dtype=torch.float32)
                                 .clamp(-8.0, 4.0))).to(torch.bfloat16)
        u = 0.3 * randn(H, dh, dtype=torch.float32)
        y, st = wkv6(r, k, v, w, u, RWKV_CHUNK)
        py, pst = wkv6_chunked(r, k, v, w, u, RWKV_CHUNK)
        err, share = check_kernel(torch, f"wkv6 {label} y", y, py)
        s_err, s_share = check_kernel(torch, f"wkv6 {label} state", st, pst,
                                      rtol=WKV_STATE_TOL, c=WKV_STATE_TOL)
        line = (f"wkv6 {label} r/k/v/w{(B, S, H, dh)}: y max|err| {err:.3e} "
                f"({share:.2f} of limit), state max|err| {s_err:.3e} "
                f"({s_share:.2f} of limit)")
        if label == "prefill":
            ms = time_ms(torch, lambda: wkv6_fwd(r, k, v, w, u, RWKV_CHUNK), flush, 20)
            plain = time_ms(torch, lambda: wkv6_chunked(r, k, v, w, u, RWKV_CHUNK),
                            flush, 5)
            nbytes = 5 * r.numel() * 2 + st.numel() * 4 + u.numel() * 4
            # the chunked form on the tensor cores: per chunk of C tokens the
            # inter-chunk and state products (2 C dh^2 each) and the scores
            # and A v over the C x C block (2 C^2 dh each)
            chunks = B * H * -(-S // WKV_CHUNK)
            flops = chunks * 4.0 * WKV_CHUNK * dh * (dh + WKV_CHUNK)
            b_ms, b_by = bound(nbytes, flops, TF32_FLOPS)
            old_flops = 4.0 * dh * dh * B * S * H  # the per-step recurrence's FMAs
            old_ms, old_by = bound(nbytes, old_flops, FP32_FLOPS)
            line += (f"  kernel {ms:.4f} ms  plain {plain:.4f} ms  library none  "
                     f"bound {b_ms:.4f} ms ({b_by}; {flops / 1e9:.2f} GFLOP at "
                     f"TF32_FLOPS, {nbytes / 1e6:.1f} MB; the per-step recurrence's "
                     f"{old_flops / 1e9:.2f} GFLOP at FP32_FLOPS: {old_ms:.4f} ms, {old_by})")
            entries["wkv6"] = dict(
                name="wkv6", route="cuda", source="src/repro_torch/csrc/wkv6.cu",
                replaces="src/repro/kernels/wkv6/kernel.py:29",
                shape=f"r/k/v/w ({B}, {S}, {H}, {dh}) bf16, u ({H}, {dh}) fp32",
                max_abs_err=err, max_err_share_of_limit=share,
                state_max_abs_err=s_err, state_max_err_share_of_limit=s_share,
                ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=None)
        log(line)
        if label == "prefill":
            check_rejects(torch, "wkv6 prefill y, u zeroed",
                          wkv6(r, k, v, w, torch.zeros_like(u), RWKV_CHUNK)[0], py)
            k_bad = k.clone()
            k_bad[:, -1] = 0
            check_rejects(torch, "wkv6 prefill state, last token's k zeroed",
                          wkv6(r, k_bad, v, w, u, RWKV_CHUNK)[1], pst,
                          rtol=WKV_STATE_TOL, c=WKV_STATE_TOL)
        if label == "train":
            train = (r, k, v, w, u)
    kernel_wkv6_backward(torch, flush, randn, entries, *train)


def kernel_adamw(torch, F, flush, randn, entries):
    """K5 AdamW over the fp32 leaf lists of the benchmark's two training
    cuts, granite-8b (8 layers) and qwen3-vl-30b-a3b (4 layers), with the
    plain loop in the same run: a step's device time (every launch: pass
    1, the scale, pass 2) beside its bound, 32 B a parameter (fp32 p, m and
    v read and written, g read twice), and the plain loop's. At both lists
    pass 1 is held to the fp64 norm of the gradients (1e-6 relative) and
    the clip scale to the plain rule's at that norm (2 ulps), and the
    control, K5 with one leaf left out of its list, must miss the norm. At
    granite's list p, m and v must equal the plain loop's bit for bit at
    K5's clip scale (the control: one ulp more scale on one leaf must not);
    the qwen3 list holds no second copy beside its 49.8 GB. Then one bf16
    leaf of 2^31 + 5 elements (64-bit offsets) bit for bit. The library
    yardstick, which the port never calls: ``torch._foreach_norm`` and
    ``torch._fused_adamw_`` with the clip passed as ``grad_scale``."""
    import math

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import common as kcommon
    from repro_torch.kernels.adamw.ops import adamw_fused, counts, launch_count
    from repro_torch.models import param_specs
    from repro_torch.models.common import tree_leaves
    from repro_torch.train.optimizer import (PIECE, OptimizerConfig, adamw_plain,
                                             clip_scale, decays, global_norm, lr_at)

    cfg = OptimizerConfig(**TRAIN_OPT)
    t = torch.tensor(1.0, device="cuda")
    lr, bc1, bc2 = (lr_at(cfg, torch.zeros((), dtype=torch.int32, device="cuda")),
                    1.0 - torch.pow(cfg.b1, t), 1.0 - torch.pow(cfg.b2, t))
    hyper = dict(b1=cfg.b1, b2=cfg.b2, eps=cfg.eps, weight_decay=cfg.weight_decay,
                 clip_norm=cfg.clip_norm)
    norm_rtol, scale_ulps = 1e-6, 2

    def state(shapes, dtype=torch.float32):
        ps = [randn(*s, dtype=torch.float32).mul_(0.02).to(dtype) for s in shapes]
        gs = [randn(*s, dtype=dtype) for s in shapes]
        ms = [randn(*s, dtype=torch.float32).mul_(1e-3).to(dtype) for s in shapes]
        vs = [randn(*s, dtype=torch.float32).square_().mul_(1e-6).to(dtype) for s in shapes]
        return ps, gs, ms, vs

    def k5(ps, gs, ms, vs):
        return adamw_fused(ps, gs, ms, vs, [decays(cfg, p) for p in ps], lr, bc1, bc2,
                           **hyper)

    def plain(ps, gs, ms, vs, scale):
        adamw_plain(cfg, list(zip(ps, gs, ms, vs)), scale, lr, bc1, bc2)

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    def library(ps, gs, ms, vs, steps, lr_f):
        # two library launches a decay group: the norm of each leaf, then
        # the update, which divides g by grad_scale (and writes it back)
        inv = torch.clamp(torch.linalg.vector_norm(torch.stack(torch._foreach_norm(gs)))
                          / cfg.clip_norm, min=1.0)
        for wd, want in ((cfg.weight_decay, True), (0.0, False)):
            idx = [i for i, p in enumerate(ps) if decays(cfg, p) == want]
            torch._fused_adamw_(*([x[i] for i in idx] for x in (ps, gs, ms, vs)), [],
                                [steps[i] for i in idx], lr=lr_f, beta1=cfg.b1,
                                beta2=cfg.b2, weight_decay=wd, eps=cfg.eps, amsgrad=False,
                                maximize=False, grad_scale=inv, found_inf=None)

    def check_norm(label, shapes, n, ps, gs, ms, vs, gnorm, scale):
        """Pass 1 against the fp64 norm, the scale against the plain rule's
        at it, and the control; raises where one fails."""
        want = torch.stack([c.double().square().sum() for g in gs
                            for c in g.view(-1).split(PIECE)]).sum().sqrt()
        w = float(want)
        rel = abs(float(gnorm) - w) / w
        want_scale = clip_scale(cfg, want.float())
        ulp = torch.nextafter(want_scale, torch.tensor(2.0, device="cuda")) - want_scale
        ulps = float((scale - want_scale).abs() / ulp)
        plain_rel = abs(float(global_norm(dict(enumerate(gs)))) - w) / w
        k = min((i for i, sh in enumerate(shapes) if math.prod(sh) >= 1e-4 * n),
                key=lambda i: math.prod(shapes[i]))
        keep = [i for i in range(len(shapes)) if i != k]
        ctl_norm, _ = k5(*([x[i] for i in keep] for x in (ps, gs, ms, vs)))
        ctl_rel = abs(float(ctl_norm) - w) / w
        line = (f"adamw {label}: grad_norm {float(gnorm):.9e}, fp64 {w:.9e} (rel "
                f"{rel:.3e}, limit {norm_rtol:g}; the plain fp32 norm's rel {plain_rel:.3e}); "
                f"scale {float(scale):.9e}, the plain rule's at the fp64 norm "
                f"{float(want_scale):.9e} ({ulps:g} ulps, limit {scale_ulps}); control "
                f"(leaf {k} {shapes[k]} left out): rel {ctl_rel:.3e}, "
                f"{'refused' if ctl_rel > norm_rtol else 'NOT refused'}")
        log(line)
        if rel > norm_rtol or ulps > scale_ulps or ctl_rel <= norm_rtol:
            raise AssertionError(line)
        return dict(grad_norm=float(gnorm), grad_norm_fp64=w, grad_norm_rel=rel,
                    plain_norm_rel=plain_rel, scale_ulps=ulps, control_rel=ctl_rel)

    for label, name, layers in (("granite-8b", "granite_8b", GRANITE_TRAIN_LAYERS),
                                ("qwen3-vl-30b-a3b", "qwen3_vl_30b_a3b", VL_TRAIN_LAYERS)):
        shapes = [tuple(sp.shape) for sp in
                  tree_leaves(param_specs(get_config(name).replace(num_layers=layers)))]
        numels = [math.prod(sh) for sh in shapes]
        n = sum(numels)
        ps, gs, ms, vs = state(shapes)
        line = f"adamw {label} ({layers} layers): {len(shapes)} fp32 leaves, {n} parameters"
        e = {}
        if label == "granite-8b":
            twin = [[x.clone() for x in xs] for xs in (ps, ms, vs)]
            k = min(range(len(shapes)), key=lambda i: (len(shapes[i]) < 2, ps[i].numel()))
            ctl = [x[k].clone() for x in (ps, ms, vs)]
        kcommon.reset_launches()
        tabled = counts["elems"]
        gnorm, scale = k5(ps, gs, ms, vs)
        launched, tabled = kcommon.launches["adamw"], counts["elems"] - tabled
        if launched != launch_count([numels]) or tabled != n:
            raise AssertionError(f"adamw {label}: launches {launched}, elements "
                                 f"tabled {tabled} of {n}")
        line += f"; launches a step {launched}, elements tabled {tabled}"
        e.update(launches_per_step=launched)
        if label == "granite-8b":
            plain(twin[0], gs, twin[1], twin[2], scale)
            ok = same(ps + ms + vs, twin[0] + twin[1] + twin[2])
            plain(ctl[:1], gs[k:k + 1], ctl[1:2], ctl[2:],
                  torch.nextafter(scale, torch.tensor(2.0, device="cuda")))
            refused = not same([ps[k], ms[k], vs[k]], ctl)
            if not ok or not refused:
                raise AssertionError(f"adamw {label}: bit-identical {ok}, control refused "
                                     f"{refused}")
            line += (f"; p, m and v bit-identical to the plain loop at K5's scale; "
                     f"control (one ulp more scale on leaf {k} {shapes[k]}) refused")
            e.update(bit_identical=ok)
            del twin, ctl
        e.update(check_norm(label, shapes, n, ps, gs, ms, vs, gnorm, scale))
        ms_k5 = time_ms(torch, lambda: k5(ps, gs, ms, vs), flush, 10)
        ms_plain = time_ms(torch, lambda: plain(ps, gs, ms, vs, scale), flush, 3, warmup=1)
        steps = [torch.ones((), device="cuda") for _ in ps]
        lr_f = float(lr)
        ms_lib = time_ms(torch, lambda: library(ps, gs, ms, vs, steps, lr_f), flush, 10)
        b_ms, b_by = bound(32.0 * n, 0.0, FP32_FLOPS)
        line += (f"  kernel {ms_k5:.4f} ms ({32.0 * n / ms_k5 / 1e9:.2f} TB/s)  plain "
                 f"{ms_plain:.4f} ms  library (foreach_norm + _fused_adamw_, never "
                 f"called by the port) {ms_lib:.4f} ms  bound {b_ms:.4f} ms ({b_by}): "
                 f"{b_ms / ms_k5:.1%}")
        log(line)
        e.update(shape=f"{label} ({layers} layers): {len(shapes)} fp32 leaves, {n} params",
                 ms=ms_k5, plain_ms=ms_plain, bound_ms=b_ms, bound_by=b_by,
                 library_ms=ms_lib)
        if label == "granite-8b":
            entries["adamw"] = dict(name="adamw", route="cuda",
                                    source="src/repro_torch/csrc/adamw.cu",
                                    replaces="none (train/optimizer.py adamw_plain)",
                                    library="torch._foreach_norm + torch._fused_adamw_ "
                                            "(a yardstick the port never calls)", **e)
        else:
            entries["adamw"]["qwen3_vl"] = e
        del ps, gs, ms, vs, steps
        torch.cuda.empty_cache()

    big = (2**31 + 5,)
    ps, gs, ms, vs = state([big], torch.bfloat16)
    twin = [[x[0].clone()] for x in (ps, ms, vs)]
    _gn, scale = k5(ps, gs, ms, vs)
    plain(twin[0], gs, twin[1], twin[2], scale)
    ok = same(ps + ms + vs, twin[0] + twin[1] + twin[2])
    log(f"adamw one bf16 leaf of {big[0]} elements (p, g, m and v bf16): bit-identical to "
        f"the plain loop {ok}")
    if not ok:
        raise AssertionError("adamw: the bf16 leaf over 2^31 elements differs from plain")
    entries["adamw"]["bf16_leaf_over_2_31_bit_identical"] = ok
    del ps, gs, ms, vs, twin
    torch.cuda.empty_cache()


KERNEL_PHASES = {"rmsnorm": kernel_rmsnorm, "flash_attention": kernel_flash_attention,
          "decode_attention": kernel_decode_attention, "wkv6": kernel_wkv6,
          "adamw": kernel_adamw}


def serving_weights(torch, cfg):
    """``serving_params(cfg, init_params(param_specs(cfg), seed=SEED))`` on
    the card, built leaf by leaf: each leaf the engine casts is cast as soon
    as it is drawn, so the whole fp32 tree never exists beside its bf16
    copy (deepseek-moe-16b's would be 62.9 GiB). The same generator stream
    and order as ``init_params``, so the same bits."""
    from repro_torch.models import param_specs
    from repro_torch.models.common import init_param
    from repro_torch.serve.engine import _CAST_ON_LOAD

    cast = _CAST_ON_LOAD[cfg.family]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)

    def build(tree, name=None):
        if isinstance(tree, dict):
            return {k: build(tree[k], k) for k in sorted(tree)}
        leaf = init_param(tree, gen, torch.device("cuda"))
        return leaf.to(cfg.cdtype) if name in cast else leaf

    with torch.inference_mode():
        return build(param_specs(cfg))


def phase_serve(torch, kcommon, cfg):
    """Full-width serving of ``cfg`` through ``ServeEngine``; returns
    (engine, launches)."""
    import numpy as np

    from repro_torch.serve.engine import Request, ServeEngine

    t0 = time.monotonic()
    torch.cuda.reset_peak_memory_stats()
    engine = ServeEngine(cfg, serving_weights(torch, cfg), max_seq=MAX_SEQ, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"{cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.param_count() / 1e9:.3f} B params; init + cast {time.monotonic() - t0:.1f} s, "
        f"peak while building {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    rng = np.random.default_rng(SEED)

    def requests(n_new):
        return [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, PROMPT, dtype=np.int32),
                        max_new_tokens=n_new) for i in range(BATCH)]

    engine.run_batch(requests(2))  # warm-up: cuBLAS handles, kernel modules
    stats0 = engine.stats.snapshot()
    torch.cuda.reset_peak_memory_stats()
    kcommon.reset_launches()
    reqs = engine.run_batch(requests(NEW_TOKENS))
    launches = dict(kcommon.launches)
    peak = torch.cuda.max_memory_allocated()

    st = engine.stats.snapshot()
    prefill_s = st["wall_prefill_s"] - stats0["wall_prefill_s"]
    decode_s = st["wall_decode_s"] - stats0["wall_decode_s"]
    steps = st["decode_steps"] - stats0["decode_steps"]
    tokens = st["tokens_out"] - stats0["tokens_out"]
    for r in reqs:
        if len(r.generated) != NEW_TOKENS or not all(0 <= t < cfg.vocab_size for t in r.generated):
            raise AssertionError(f"request {r.rid}: bad output {r.generated}")
    want = dense_launches(cfg, steps)
    if steps != NEW_TOKENS - 1 or launches != want:
        raise AssertionError(f"{cfg.name}: launch counts {launches} (decode steps {steps}), "
                             f"want {want}")
    log(f"{cfg.name} serve: batch {BATCH} x prompt {PROMPT}, {NEW_TOKENS} new tokens each: "
        f"prefill {prefill_s * 1e3:.2f} ms; decode {steps} steps in {decode_s * 1e3:.2f} ms "
        f"({decode_s / steps * 1e3:.3f} ms/step, {tokens / decode_s:.1f} tokens/s "
        f"as tokens_out / wall_decode_s); max_memory_allocated {peak / 2**30:.2f} GiB")
    log(f"{cfg.name} serve launches: {launches} (expected {want})")
    log(f"{cfg.name} serve sample: request 0 generated {reqs[0].generated[:8]} ...")
    return engine, launches


def phase_drops(torch, cfg, params):
    """Each MoE layer's share of dropped choices (past its expert's
    capacity) in one prefill of BATCH x PROMPT tokens."""
    import numpy as np

    from repro_torch.models import init_decode_state, moe, prefill

    rng = np.random.default_rng(SEED)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (BATCH, PROMPT))).cuda()
    shares = []

    def recording(routing):
        def run(cfg_, p, xt):
            out = routing(cfg_, p, xt)
            shares.append((~out[5]).float().mean())
            return out
        return run

    with torch.inference_mode(), swapped(moe, "_routing", recording):
        prefill(cfg, params, {"tokens": tokens},
                cache=init_decode_state(cfg, BATCH, MAX_SEQ, device="cuda"))
    shares = [float(x) for x in shares]
    if len(shares) != cfg.num_layers:
        raise AssertionError(f"{cfg.name}: {len(shares)} routing calls in a prefill")
    log(f"{cfg.name} prefill of {BATCH} x {PROMPT} tokens, capacity "
        f"{moe.capacity(cfg, BATCH * PROMPT)} a expert: dropped share of the "
        f"{cfg.moe_top_k} choices a token, by layer: {[f'{x:.4f}' for x in shares]} "
        f"(mean {statistics.mean(shares):.4f})")


def dense_launches(cfg, steps):
    """Launches of one transformer prefill and ``steps`` decode steps: two
    norms a layer and the final one each time, K1 once a layer in the
    prefill, K3 once a layer a step."""
    return {"rmsnorm": (2 * cfg.num_layers + 1) * (1 + steps),
            "flash_attention": cfg.num_layers,
            "decode_attention": cfg.num_layers * steps, "wkv6": 0, "wkv6_bwd": 0,
            "adamw": 0}


def rwkv_launches(cfg, steps):
    """Launches of one rwkv6 prefill and ``steps`` decode steps: three norms
    a layer and the final one each time, WKV6 once a layer in the prefill
    (decode steps the recurrence as plain tensor code)."""
    norms = 3 * cfg.num_layers + 1
    return {"rmsnorm": norms * (1 + steps), "flash_attention": 0, "decode_attention": 0,
            "wkv6": cfg.num_layers, "wkv6_bwd": 0, "adamw": 0}


def hybrid_launches(cfg, steps):
    """Launches of one zamba2 prefill and ``steps`` decode steps: two norms a
    Mamba2 layer and a shared-block invocation and the final one each time,
    K1 once an invocation in the prefill, K3 once an invocation a step."""
    groups = cfg.num_layers // cfg.attn_every
    norms = 2 * cfg.num_layers + 2 * groups + 1
    return {"rmsnorm": norms * (1 + steps), "flash_attention": groups,
            "decode_attention": groups * steps, "wkv6": 0, "wkv6_bwd": 0, "adamw": 0}


def phase_serve_direct(torch, kcommon, cfg, expected, prefix=0):
    """Full-width serving of ``cfg`` through the model-level API (``prefill``
    into a preallocated state, then greedy ``decode_step``, the host reading
    each token; ``ServeEngine`` refuses the RWKV and hybrid families as the
    JAX engine does, and the audio family, on which the JAX engine fails).
    With ``prefix``, each prompt follows that many seeded frame embeddings,
    and the state holds them too. ``expected(cfg, steps)`` gives the
    launches of a prefill and ``steps`` decode steps. Returns (params,
    launches)."""
    import numpy as np

    from repro_torch.models import decode_step, init_decode_state, prefill

    t0 = time.monotonic()
    torch.cuda.reset_peak_memory_stats()
    params = serving_weights(torch, cfg)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"{cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.param_count() / 1e9:.3f} B params; init + cast {time.monotonic() - t0:.1f} s, "
        f"peak while building {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    rng = np.random.default_rng(SEED)

    @torch.inference_mode()
    def serve(n_new):
        """Prefill, then greedy decode as ServeEngine.run_batch does it (the
        host reads each token). Returns (tokens, prefill s, decode s,
        launches counted by the end of prefill, last logits)."""
        batch = model_inputs(torch, cfg, token_grid(torch, cfg, rng, BATCH, PROMPT),
                             prefix, SEED)
        t0 = time.monotonic()
        state = init_decode_state(cfg, BATCH, prefix + MAX_SEQ, device="cuda")
        logits, state = prefill(cfg, params, batch, cache=state)
        torch.cuda.synchronize()
        prefill_s = time.monotonic() - t0
        at_prefill = dict(kcommon.launches)
        tok, out = torch.argmax(logits, dim=-1), []
        t0 = time.monotonic()
        for i in range(n_new):
            out.append(tok.cpu())
            if i + 1 == n_new:
                break
            logits, state = decode_step(cfg, params, state, tok, prefix + PROMPT + i)
            tok = torch.argmax(logits, dim=-1)
        torch.cuda.synchronize()
        return torch.stack(out, 1), prefill_s, time.monotonic() - t0, at_prefill, logits

    serve(2)  # warm-up: cuBLAS handles, kernel modules
    torch.cuda.reset_peak_memory_stats()
    kcommon.reset_launches()
    tokens, prefill_s, decode_s, at_prefill, logits = serve(NEW_TOKENS)
    launches = dict(kcommon.launches)
    peak = torch.cuda.max_memory_allocated()

    steps = NEW_TOKENS - 1
    want_prefill, want = expected(cfg, 0), expected(cfg, steps)
    if at_prefill != want_prefill or launches != want:
        raise AssertionError(f"{cfg.name} launch counts {at_prefill} after prefill, {launches} "
                             f"after {steps} decode steps; want {want_prefill}, {want}")
    audio = cfg.family == "audio"
    want_shape = (BATCH, NEW_TOKENS) + ((cfg.num_codebooks,) if audio else ())
    if tuple(tokens.shape) != want_shape or not bool(
            ((tokens >= 0) & (tokens < cfg.vocab_size)).all()):
        raise AssertionError(f"{cfg.name}: bad tokens {tokens}")
    if tuple(logits.shape) != (BATCH,) + want_shape[2:] + (cfg.vocab_size,) \
            or not bool(torch.isfinite(logits.float()).all()):
        raise AssertionError(f"{cfg.name}: logits of shape {tuple(logits.shape)} "
                             f"or non-finite")
    rate = (f"{BATCH * NEW_TOKENS / decode_s:.1f} frames/s, {tokens.numel() / decode_s:.1f} "
            f"codebook tokens/s" if audio else f"{tokens.numel() / decode_s:.1f} tokens/s")
    log(f"{cfg.name} serve: batch {BATCH} x prompt {PROMPT}"
        + (f" {'frames' if audio else 'tokens'} after {prefix} frame embeddings "
           f"(state of {prefix + MAX_SEQ} positions)" if prefix else "")
        + f", {NEW_TOKENS} new each: "
        f"prefill {prefill_s * 1e3:.2f} ms; decode {steps} steps in {decode_s * 1e3:.2f} ms "
        f"({decode_s / steps * 1e3:.3f} ms/step, {rate} "
        f"as tokens out / decode wall); max_memory_allocated {peak / 2**30:.2f} GiB")
    log(f"{cfg.name} serve launches: {at_prefill} after prefill, {launches} in all "
        f"(expected {want_prefill}, {want})")
    log(f"{cfg.name} serve sample: sequence 0 generated {tokens[0, :8].tolist()} ...")
    return params, launches


def phase_profile(torch, name, cfg, params, prefix=0):
    """Where serving time goes: device-busy share of one prefill (after
    ``prefix`` frame embeddings) and of 8 decode steps (torch.profiler, CUDA
    activity only), and the kernels that take the most device time."""
    import numpy as np

    from repro_torch.models import decode_step, init_decode_state, prefill

    tokens = token_grid(torch, cfg, np.random.default_rng(SEED), BATCH, PROMPT)
    batch = model_inputs(torch, cfg, tokens, prefix, SEED)
    with torch.inference_mode():
        state = init_decode_state(cfg, BATCH, prefix + MAX_SEQ, device="cuda")

        def run_prefill():
            prefill(cfg, params, batch, cache=state)

        def run_decode():  # as ServeEngine.run_batch: the host reads each token
            tok = tokens[:, -1]
            for i in range(8):
                logits, _ = decode_step(cfg, params, state, tok, prefix + PROMPT + i)
                tok = torch.argmax(logits, dim=-1)
                tok.cpu()

        for label, fn in (("prefill", run_prefill), ("8 decode steps", run_decode)):
            device_profile(torch, f"{name} {label}", fn)


def open_trace(torch):
    """Launch TRACER_MARKERS spin kernels and wait for them: the first thing
    in each profile, so the device events the tracer drops are theirs."""
    for _ in range(TRACER_MARKERS):
        torch.cuda._sleep(100)
    torch.cuda.synchronize()


def device_profile(torch, label, fn):
    """Run ``fn`` once under torch.profiler (CUDA activity only), after the
    tracer's markers; log the wall, the device-busy share and the 8 largest
    device lines, the markers left out. Returns (rows as (device us, key),
    busy s)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        open_trace(torch)
        t0 = time.monotonic()
        fn()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    rows = sorted(((e.self_device_time_total, e.key) for e in prof.key_averages()
                   if e.self_device_time_total > 0 and "spin_kernel" not in e.key),
                  reverse=True)
    busy = sum(t for t, _ in rows) / 1e6
    if busy <= 0:
        raise AssertionError(f"profile {label}: the profiler saw no device time")
    log(f"profile {label}: wall {wall * 1e3:.2f} ms (profiler on), device busy "
        f"{busy * 1e3:.2f} ms = {busy / wall:.1%} of wall")
    for t, key in rows[:8]:
        log(f"    {t / 1e3:9.3f} ms  {t / 1e6 / busy:6.1%}  {key[:90]}")
    return rows, busy


@contextlib.contextmanager
def plain_path():
    """Swap the models' kernel entry points for their plain versions (a
    comparison device of this script only; the port itself has no such
    switch)."""
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    from repro_torch.kernels.wkv6.ref import wkv6_chunked
    from repro_torch.models import mamba2, rwkv6, transformer

    plain = {
        (transformer, "rms_norm"): rmsnorm_ref,
        (transformer, "attention"): flash_attention_ref,
        (transformer, "decode_attention"): decode_attention_ref,
        (rwkv6, "rms_norm"): rmsnorm_ref,
        (rwkv6, "wkv6"): wkv6_chunked,
        (mamba2, "rms_norm"): rmsnorm_ref,
        (mamba2, "attention"): flash_attention_ref,
        (mamba2, "decode_attention"): decode_attention_ref,
    }
    saved = {key: getattr(*key) for key in plain}
    for (mod, name), fn in plain.items():
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)


class RoutingReplay:
    """A swap of the port's MoE routing (a comparison device of this script
    only): while ``recording``, each call's top-k choices are kept; after,
    each call takes the next kept choices in call order, with its own
    probabilities, gates and dispatch (``moe.plan``), and counts the
    choices it would have made otherwise. Routing is discontinuous: the
    kernel path's bf16 hidden states can tip a near-tied choice, and through
    capacity move another token's, so kernels-vs-plain compares the kernels
    under one routing."""

    def __init__(self, torch):
        from repro_torch.models import moe

        self.torch, self.moe = torch, moe
        self.recording, self.kept, self.flips, self.at = True, [], [], 0

    def _routing(self, routing):
        moe = self.moe

        def run(cfg, p, xt):
            if self.recording:
                out = routing(cfg, p, xt)
                self.kept.append(out[2])
                return out
            probs = moe.router_probs(p, xt)
            want = self.kept[self.at]
            self.at += 1
            self.flips.append(int((moe.top_k(probs, cfg.moe_top_k)[1] != want).sum()))
            return moe.plan(cfg, probs, want)
        return run

    @contextlib.contextmanager
    def replaying(self):
        """The replay (or, before any call was kept, nothing: the dense and
        RWKV families route nothing) from the first kept call on."""
        self.recording, self.at, self.flips = False, 0, []
        try:
            yield
        finally:
            if self.at != len(self.kept):
                raise AssertionError(f"routing replay: {self.at} calls replayed of "
                                     f"{len(self.kept)} kept")

    def __enter__(self):
        self._swap = swapped(self.moe, "_routing", self._routing)
        self._swap.__enter__()
        return self

    def __exit__(self, *exc):
        return self._swap.__exit__(*exc)


def cut_params(cfg, params, n):
    """The first ``n`` layers of ``cfg`` and of its parameters (views; the
    hybrid's stacked leaves are its Mamba2 layers', its shared block whole)."""
    stack = "mamba" if cfg.family == "hybrid" else "layers"
    return cfg.replace(num_layers=n), dict(
        params, **{stack: {k: v[:n] for k, v in params[stack].items()}})


def phase_kernel_vs_plain(torch, name, cfg, params, layers=2, control=None, prefix=0):
    """A ``layers``-layer cut at full width: kernel path vs plain path on the
    card (the MoE family under the kernel path's routing, ``RoutingReplay``),
    the prompts after ``prefix`` frame embeddings. ``control``, (name,
    context), runs the kernel path under a fault that the check must refuse
    at every step."""
    import numpy as np

    from repro_torch.models import decode_step, init_decode_state, prefill

    cfg, params = cut_params(cfg, params, layers)
    rng = np.random.default_rng(SEED + 1)
    batch = model_inputs(torch, cfg, token_grid(torch, cfg, rng, BATCH, PROMPT), prefix,
                         SEED + 1)
    cut = f"{name} {layers}-layer cut"

    def run():
        state = init_decode_state(cfg, BATCH, prefix + MAX_SEQ, device="cuda")
        logits, state = prefill(cfg, params, batch, cache=state)
        outs = [logits]
        for i, tok in enumerate(feed):
            logits, state = decode_step(cfg, params, state, tok, prefix + PROMPT + i)
            outs.append(logits)
        return outs

    with torch.inference_mode():
        feed = []
        kernel = run()  # pass 1 only fixes the fed tokens
        feed = [torch.argmax(kernel[0], -1)]
        for _ in range(2):
            feed.append((feed[-1] * 7 + 1) % cfg.vocab_size)
        with RoutingReplay(torch) as replay:
            kernel = run()
            with replay.replaying(), plain_path():
                plain = run()
            if control is not None:
                with replay.replaying(), control[1]():
                    faulty = run()
    if replay.kept:
        log(f"{cut}: the plain path replays the kernel path's routing "
            f"({len(replay.kept)} calls: prefill, then each decode step, layer by layer); "
            f"choices it would have made otherwise, per call: {replay.flips} of "
            f"{[int(k.numel()) for k in replay.kept]}")
    steps = ["prefill logits"] + [f"decode step {i} logits" for i in range(1, len(kernel))]
    rms = [float(b.float().pow(2).mean().sqrt()) for b in plain]

    def readings(tag, outs):
        rows = [read_close(torch, f"{cut} {step}", a, b)
                for step, a, b in zip(steps, outs, plain)]
        log(f"{cut}, {tag} vs plain on the card (bf16, atol = rtol = {E2E_TOL}; "
            f"prefill, then decode steps 1-{len(rows) - 1}): max|err| "
            f"{[f'{r[0]:.3e}' for r in rows]}; worst element's share of atol + rtol |plain| "
            f"{[f'{r[1]:.3f}' for r in rows]}; RMS(diff) / RMS(plain) "
            f"{[f'{r[2]:.4f}' for r in rows]}; RMS of the plain logits "
            f"{[f'{r:.3f}' for r in rms]}")
        return [step for step, r in zip(steps, rows) if r[3]]

    held = readings("kernels", kernel)
    let_through = readings(f"control ({control[0]})", faulty) if control else []
    if held != steps or let_through:  # every reading is printed first
        raise AssertionError(f"{cut}: {sorted(set(steps) - set(held))} over the allclose "
                             f"limit atol = rtol = {E2E_TOL}; the control let through "
                             f"{let_through}")
    if control:
        log(f"  control {cut} ({control[0]}): refused at every step")


def leaf_paths(tree, prefix=""):
    """Dotted paths of a parameter tree's leaves, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in leaf_paths(tree[k], f"{prefix}{k}.")]
    return [prefix[:-1]]


def expected_train_launches(cfg):
    """Kernel launches of one train step with remat: each forward kernel in
    the forward and again in its layer's recompute; the final norm, outside
    the layers, once. The hybrid nests its remat as the reference does: a
    Mamba2 layer inside a group of ``attn_every`` runs forward three times
    (the forward, the group's recompute, its own recompute), the shared
    block and a tail layer twice. K4's backward runs once a layer. AdamW
    is K5 over the fp32 leaves: two launches for each table of leaves and
    one for the clip scale."""
    import math

    from repro_torch.kernels.adamw.ops import launch_count
    from repro_torch.models import param_specs
    from repro_torch.models.common import tree_leaves
    numels = [math.prod(s.shape) for s in tree_leaves(param_specs(cfg))]
    want = {"rmsnorm": 1, "flash_attention": 0, "decode_attention": 0, "wkv6": 0,
            "wkv6_bwd": 0, "adamw": launch_count([numels])}
    if cfg.family == "hybrid":
        groups = cfg.num_layers // cfg.attn_every
        tail = cfg.num_layers - groups * cfg.attn_every
        want["rmsnorm"] += 2 * (3 * groups * cfg.attn_every + 2 * groups + 2 * tail)
        want["flash_attention"] = 2 * groups
        return want
    per_layer = ({"rmsnorm": 3, "wkv6": 1} if cfg.family == "rwkv"
                 else {"rmsnorm": 2, "flash_attention": 1})
    for name, n in per_layer.items():
        want[name] += 2 * n * cfg.num_layers
    if cfg.family == "rwkv":
        want["wkv6_bwd"] = cfg.num_layers
    return want


@contextlib.contextmanager
def swapped(mod, name, fn):
    """``mod.name`` replaced by ``fn(original)`` inside the block."""
    saved = getattr(mod, name)
    setattr(mod, name, fn(saved))
    try:
        yield
    finally:
        setattr(mod, name, saved)


@contextlib.contextmanager
def timed_rules(torch):
    """Bracket every call of each backward rule and of the AdamW update
    with CUDA events (a measuring device of this script only). Yields
    {name: [(start, end), ...]}."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.kernels.wkv6 import ops as wkv_ops
    from repro_torch.train import step as step_mod

    targets = {"rmsnorm_bwd": rms_ops, "flash_attention_bwd": fa_ops,
               "wkv6_bwd": wkv_ops, "adamw_update": step_mod}
    events = {name: [] for name in targets}

    def timed(name):
        def wrap(fn):
            def run(*a, **kw):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = fn(*a, **kw)
                end.record()
                events[name].append((start, end))
                return out
            return run
        return wrap

    with contextlib.ExitStack() as stack:
        for name, mod in targets.items():
            stack.enter_context(swapped(mod, name, timed(name)))
        yield events


def token_grid(torch, cfg, rng, rows, n):
    """Tokens (rows, n) from the numpy generator ``rng``, or (rows, n, K)
    over the audio family's K codebooks, on the card."""
    shape = (rows, n, cfg.num_codebooks) if cfg.family == "audio" else (rows, n)
    return torch.from_numpy(rng.integers(0, cfg.vocab_size, shape)).cuda()


def model_inputs(torch, cfg, tokens, prefix, seed):
    """The model's batch: ``tokens`` and, with ``prefix``, seeded fp32 frame
    embeddings (rows, prefix, d_model) before them."""
    batch = {"tokens": tokens}
    if prefix:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed + 3)
        batch["frontend_embeds"] = torch.randn((tokens.shape[0], prefix, cfg.d_model),
                                               generator=gen, device="cuda")
    return batch


def train_batch(torch, cfg, prefix=0, seed=SEED):
    """Seeded TRAIN_GB x TRAIN_SEQ tokens (of K codebooks for audio) and,
    with ``prefix``, seeded fp32 frame embeddings (TRAIN_GB, prefix,
    d_model) before them."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return model_inputs(torch, cfg, token_grid(torch, cfg, rng, TRAIN_GB, TRAIN_SEQ),
                        prefix, seed)


def phase_train(torch, kcommon, label, cfg, prefix=0):
    """Full-width training: TRAIN_STEPS AdamW steps on one batch (after
    ``prefix`` frame embeddings a row, if any), then one profiled step.
    Returns the launches of the TRAIN_STEPS steps and each step's wall
    ms."""
    import numpy as np

    from repro_torch.models import init_params, param_specs
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.moe import capacity as moe_capacity
    from repro_torch.train import (OptimizerConfig, StepConfig, init_opt_state,
                                   make_train_step)

    t0 = time.monotonic()
    params = init_params(param_specs(cfg), seed=SEED, device="cuda")
    opt = init_opt_state(params)
    torch.cuda.synchronize()
    n = cfg.param_count()
    log(f"{label} train: {cfg.num_layers} layers, d_model {cfg.d_model}, {n / 1e9:.3f} B "
        f"params; fp32 params, grads, m and v {16 * n / 1e9:.1f} GB; init "
        f"{time.monotonic() - t0:.1f} s")
    batch = train_batch(torch, cfg, prefix)
    if prefix:
        log(f"{label} train: {TRAIN_GB} x {TRAIN_SEQ} tokens after a prefix of {prefix} "
            f"frame embeddings a row (fp32, seeded): {TRAIN_SEQ + prefix} positions"
            + (f"; MoE capacity {moe_capacity(cfg, TRAIN_GB * (TRAIN_SEQ + prefix))} "
               f"a expert" if cfg.family == "moe" else ""))
    codebooks = cfg.num_codebooks if cfg.family == "audio" else 1
    step = make_train_step(cfg, OptimizerConfig(**TRAIN_OPT), StepConfig(microbatches=1))
    samples = [p.view(-1)[:4096].clone() for p in tree_leaves(params)]
    want = expected_train_launches(cfg)
    tokens = TRAIN_GB * TRAIN_SEQ

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kcommon.reset_launches()
    readings, before = [], dict(kcommon.launches)
    for i in range(TRAIN_STEPS):
        t0 = time.monotonic()
        params, opt, metrics = step(params, opt, batch)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        now = dict(kcommon.launches)
        per_step = {k: now[k] - before[k] for k in now}
        before = now
        m = {k: float(v) for k, v in metrics.items()}
        readings.append((m, per_step, wall * 1e3))
        rate = (f"{tokens / wall:.1f} frames/s, {codebooks * tokens / wall:.1f} codebook "
                f"tokens/s" if codebooks > 1 else f"{tokens / wall:.1f} tokens/s")
        log(f"{label} train step {i + 1}: loss {m['loss']:.6f}  aux_loss {m['aux_loss']:.6f}"
            f"  grad_norm {m['grad_norm']:.6f}  lr {m['lr']:.3e}  {wall * 1e3:.2f} ms  "
            f"{rate}  launches {per_step}")
    launches = dict(kcommon.launches)
    peak = torch.cuda.max_memory_allocated()
    moved = sum(bool((p.view(-1)[:4096] != s).any())
                for p, s in zip(tree_leaves(params), samples))
    log(f"{label} train: max_memory_allocated {peak / 2**30:.2f} GiB; launches per step "
        f"expected {want}; leaves whose first 4096 elements moved: {moved} of {len(samples)}")

    # one more step, profiled, with each backward rule and AdamW bracketed
    with timed_rules(torch) as events:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)

        def run():
            nonlocal params, opt
            start.record()
            params, opt, _ = step(params, opt, batch)
            end.record()

        rows, busy = device_profile(torch, f"{label} train step", run)
    step_ms = start.elapsed_time(end)
    parts = {name: sum(s.elapsed_time(e) for s, e in ev) for name, ev in events.items()}
    parts.update({f"{k} forward kernel": sum(t for t, key in rows if sym in key) / 1e3
                  for k, sym in KERNEL_SYMBOLS.items()
                  if want[k] and k not in ("adamw", "wkv6_bwd")})
    log(f"{label} train step, device time by part (CUDA events around each backward rule "
        f"and AdamW; the profiler's kernel lines for the forward kernels): step {step_ms:.2f} ms; "
        + "; ".join(f"{k} {v:.2f} ms = {v / step_ms:.1%}" for k, v in parts.items()))

    bad = [i + 1 for i, (m, per_step, _) in enumerate(readings)
           if per_step != want or not all(np.isfinite([m["loss"], m["grad_norm"]]))
           or (m["aux_loss"] > 0) != (cfg.family == "moe")]
    if bad or moved != len(samples):
        raise AssertionError(f"{label} train: steps {bad} have non-finite loss or grad norm, "
                             f"an aux loss its family does not give, or launches other "
                             f"than {want}; {moved} of {len(samples)} leaves moved")
    return launches, [ms for _, _, ms in readings]


class GridSource:
    """Phase 9's wrapper of the loop's ``ReaderFanInSource``: records the
    cursors before each fetch (the replay snapshots) and, as the negative
    control, can hand the loop each grid with its two DP halves swapped."""

    def __init__(self, inner, swap_dp_halves=False):
        self.inner, self.topology = inner, inner.topology
        self.swap = swap_dp_halves
        self.snapshots = []

    def next_tokens(self, timeout_s=None):
        import numpy as np

        snap = self.inner.cursors()
        grid = self.inner.next_tokens(timeout_s=timeout_s)
        self.snapshots.append(snap)
        if self.swap:
            half = grid.shape[0] // 2
            grid = np.concatenate([grid[half:], grid[:half]])
        return grid

    def cursors(self):
        return self.inner.cursors()

    def restore(self, cursors):
        self.inner.restore(cursors)

    def start_prefetch(self):
        self.inner.start_prefetch()

    def stop_prefetch(self):
        self.inner.stop_prefetch()


def fused_stream(np, cfg):
    """Phase 9's token stream: FUSED_BATCHES global batches, token t at
    position p = (7 p + 3) mod vocab."""
    n = FUSED_BATCHES * TRAIN_GB * TRAIN_SEQ
    return ((np.arange(n) * 7 + 3) % cfg.vocab_size).astype(np.int32)


def packer_grids(np, topo, tokens):
    """The grids the host packer makes from ``tokens``, without a store."""
    from repro_torch.data.packing import GlobalBatchPacker, assemble_grid

    packer = GlobalBatchPacker(TRAIN_GB, TRAIN_SEQ, topo.dp, topo.cp)
    return [assemble_grid(b.slices, TRAIN_GB, TRAIN_SEQ, topo.dp, topo.cp)
            for b in packer.add_tokens(tokens)]


def colocated_source(np, topo, vocab):
    """fig17's colocated arm (``_source_colocated``): a ``ColocatedConfig()``
    worker pool, COLOC_COST_S a sample, TRAIN_GB sample indices a pull, each
    index mapped to its TRAIN_SEQ-token slice of phase 9's stream and packed
    by ``PackingTokenSource`` on the staging thread. Returns (source, the
    pool's writer, which is started, the indices of every pull in order,
    the grid a list of indices must pack to)."""
    from repro_torch.data import ColocatedConfig
    from repro_torch.dataplane import open_dataplane
    from repro_torch.train.pipeline import PackingTokenSource

    def sample_tokens(indices):
        offs = indices.astype(np.int64)[:, None] * TRAIN_SEQ + np.arange(TRAIN_SEQ)[None, :]
        return ((offs.ravel() * 7 + 3) % vocab).astype(np.int32)

    session = open_dataplane(None, topo, backend="colocated", namespace="runs/fused",
                             config=ColocatedConfig(),
                             preprocess_cost_s=lambda i: COLOC_COST_S,
                             batch_cpu_items=TRAIN_GB)
    writer, reader, pulled = session.writer(), session.reader(), []

    def pull(timeout_s):
        indices = np.frombuffer(reader.next_batch(timeout_s=timeout_s).payload,
                                dtype=np.int32)
        pulled.append(indices.copy())
        return sample_tokens(indices)

    writer.__enter__()  # start the worker pool
    return (PackingTokenSource(pull, topo), writer, pulled,
            lambda indices: packer_grids(np, topo, sample_tokens(indices))[0])


def state_leaves(params, opt):
    from repro_torch.models.common import tree_leaves

    return tree_leaves({"params": params, "opt": opt})


def restore_state(torch, params, opt, saved):
    """Copy ``saved`` (leaves in ``state_leaves`` order) into the state the
    train step updates in place."""
    with torch.no_grad():
        for t, s in zip(state_leaves(params, opt), saved):
            t.copy_(s)


def phase_fused(torch, kcommon, cfg, phase6_ms, smi):
    """fig17's three arms on the card: the granite-8b cut (8 of 36 layers)
    trained through ``FusedTrainLoop`` off the colocated pool, the mq broker
    and the tgb store (S3-class latency), at depth 0 and 2, each arm from
    one saved state; check_fig17's gates on the tgb arm; then a replay of
    the tgb depth-2 arm from a cursor snapshot and a negative control.
    Returns the launches of the arms and the replay."""
    import numpy as np

    from repro_torch.core import LatencyModel, MemoryObjectStore
    from repro_torch.data import BrokerConfig, KafkaSimBroker
    from repro_torch.dataplane import Topology, open_dataplane
    from repro_torch.launch.roofline import PEAK_FLOPS, ideal_step_s
    from repro_torch.models import init_params, param_specs
    from repro_torch.train import (OptimizerConfig, StepConfig, init_opt_state,
                                   make_train_step)
    from repro_torch.train.pipeline import FusedTrainLoop, ReaderFanInSource

    topo = Topology(dp=FUSED_DP, cp=FUSED_CP, global_batch=TRAIN_GB, seq_len=TRAIN_SEQ)
    stream = fused_stream(np, cfg)
    host_grids = packer_grids(np, topo, stream)
    sessions = {"tgb": open_dataplane(MemoryObjectStore(latency=LatencyModel()), topo,
                                      namespace="runs/fused"),
                "mq": open_dataplane(KafkaSimBroker(BrokerConfig()), topo, backend="mq",
                                     namespace="runs/fused")}
    for backend, session in sessions.items():
        t0 = time.monotonic()
        with session.writer("w0") as w:
            offsets = w.write_tokens(stream)
        log(f"fused: {len(offsets)} TGBs of {TRAIN_GB} x {TRAIN_SEQ} tokens "
            f"({TRAIN_GB * TRAIN_SEQ * 4 // 1024} KiB, a rank's slice "
            f"{TRAIN_GB * TRAIN_SEQ * 4 // topo.world // 1024} KiB; dp {topo.dp}, cp {topo.cp}) "
            f"written in {time.monotonic() - t0:.2f} s to "
            + ("a MemoryObjectStore with LatencyModel() (S3-class)" if backend == "tgb"
               else "a KafkaSimBroker with BrokerConfig() (one message a TGB)"))

    def fan_in(backend):
        opts = {"prefetch_depth": 4} if backend == "tgb" else {}
        return ReaderFanInSource([sessions[backend].reader(dp_rank=d, cp_rank=c, **opts)
                                  for d in range(topo.dp) for c in range(topo.cp)], topo)

    params = init_params(param_specs(cfg), seed=SEED, device="cuda")
    opt = init_opt_state(params)
    saved = [t.clone() for t in state_leaves(params, opt)]
    step = make_train_step(cfg, OptimizerConfig(**TRAIN_OPT), StepConfig(microbatches=1))
    want = expected_train_launches(cfg)
    per_step, device_tokens = [], []

    def checked_step(p, o, batch):
        # the device tokens as the step sees them (copied on its stream)
        # and the launches of this step alone
        device_tokens.append(batch["tokens"].clone())
        before = dict(kcommon.launches)
        out = step(p, o, batch)
        per_step.append({k: kcommon.launches[k] - before[k] for k in before})
        return out

    def drive(src, depth, steps, want_grid, profile_last=False):
        """One loop run over ``src``, ``steps`` a tuple of ``run`` lengths
        (the last under torch.profiler if ``profile_last``); ``want_grid(i)``
        is the grid step i must consume. Returns (grids, mismatches,
        reports, loop)."""
        nonlocal params, opt
        grids, mismatches, reports = [], [], []
        device_tokens.clear()
        per_step.clear()

        def on_batch(i, host):
            grids.append(host.copy())
            if host.dtype != np.int32 or not np.array_equal(host, want_grid(i)):
                mismatches.append(f"grid {i}: not the host packer's")

        loop = FusedTrainLoop(src, checked_step, params, opt, topology=topo,
                              depth=depth, timeout_s=60.0)
        with loop:
            for k, n_steps in enumerate(steps):
                if profile_last and k == len(steps) - 1:
                    device_profile(torch, f"fused tgb depth {depth}, {n_steps} steps",
                                   lambda: reports.append(loop.run(n_steps, on_batch=on_batch)))
                else:
                    reports.append(loop.run(n_steps, on_batch=on_batch))
        params, opt = loop.params, loop.opt_state
        for i, (dev, host) in enumerate(zip(device_tokens, grids)):
            back = dev.cpu().numpy()
            if dev.dtype != torch.int32 or not np.array_equal(back, host):
                mismatches.append(f"step {i}: device tokens are not the host tokens")
        for i, launches in enumerate(per_step):
            if launches != want:
                mismatches.append(f"step {i}: launches {launches}, want {want}")
        for r in reports:
            for t in r.timings:
                if not np.isfinite(t.loss):
                    mismatches.append(f"step {t.step}: loss {t.loss}")
        return grids, mismatches, reports, loop

    roofline_s = ideal_step_s(cfg.param_count(), TRAIN_GB * TRAIN_SEQ)
    torch.cuda.synchronize()
    kcommon.reset_launches()
    arms = {}
    # depth-major, as fig17: the gate compares backends at equal depth, and
    # running those arms back to back keeps drift out of the comparison
    for depth in FIG17_DEPTHS:
        for backend in FIG17_BACKENDS:
            restore_state(torch, params, opt, saved)
            t_arm = time.monotonic()
            writer = None
            if backend == "colocated":
                src, writer, pulled, grid_of = colocated_source(np, topo, cfg.vocab_size)
                want_grid = lambda i, pulled=pulled, grid_of=grid_of: grid_of(pulled[i])  # noqa: E731
            else:
                src = GridSource(fan_in(backend))
                want_grid = host_grids.__getitem__
            profile = backend == "tgb" and depth > 0
            torch.cuda.reset_peak_memory_stats()
            try:
                grids, bad, reports, loop = drive(
                    src, depth, (FUSED_WARMUP, FUSED_TIMED) + ((FUSED_PROFILED,) if profile else ()),
                    want_grid, profile_last=profile)
            finally:
                if writer is not None:
                    writer.__exit__(None, None, None)
            peak = torch.cuda.max_memory_allocated()
            if bad:
                raise AssertionError(f"fused {backend} depth {depth}: {bad}")
            rep = reports[1]
            med = statistics.median(t.wall_s for t in rep.timings)
            attr = rep.attribution(roofline_step_s=roofline_s)
            amp = ([r.stats.read_amplification for r in src.inner.readers]
                   if backend == "mq" else None)
            arms[(backend, depth)] = dict(
                grids=grids, loop=loop, src=src, rep=rep, tokens_per_s=TRAIN_GB * TRAIN_SEQ / med,
                losses=[t.loss for r in reports[:2] for t in r.timings], attr=attr)
            fr = rep.stall_fractions()
            log(f"fused {backend} depth {depth}: {rep.steps} timed steps after {FUSED_WARMUP} "
                f"warm-up: {TRAIN_GB * TRAIN_SEQ / med:.1f} tokens/s at the median step "
                f"({med * 1e3:.2f} ms; fig17's reading), {rep.tokens_per_s:.1f} over the run; split "
                f"data_wait {fr['data_wait']:.4f} h2d {fr['h2d']:.4f} compute {fr['compute']:.4f} "
                f"other {fr['other']:.4f}; compute_vs_roofline {attr['compute_vs_roofline']:.3f}; "
                f"K2 / K1 launches a step {per_step[0]['rmsnorm']} / "
                f"{per_step[0]['flash_attention']}"
                + (f"; read amplification {[round(a, 4) for a in amp]} (D x C = {topo.world})"
                   if amp else "")
                + f"; max_memory_allocated {peak / 2**30:.2f} GiB; arm {time.monotonic() - t_arm:.1f} s")
            log(f"    per step ms {[round(t.wall_s * 1e3, 2) for t in rep.timings]}; compute ms "
                f"{[round(t.compute_s * 1e3, 2) for t in rep.timings]} (phase 6's step ms "
                f"{[round(ms, 2) for ms in phase6_ms]}); data_wait ms "
                f"{[round(t.data_wait_s * 1e3, 2) for t in rep.timings]}; h2d ms "
                f"{[round(t.h2d_s * 1e3, 3) for t in rep.timings]}; losses "
                f"{[round(x, 5) for x in rep.losses]}")
            if amp is not None and not all(a > topo.world for a in amp):
                raise AssertionError(f"fused mq: read amplification {amp}, want > D x C "
                                     f"= {topo.world} (whole-message fetch)")
    log(f"fused: roofline {roofline_s * 1e3:.2f} ms a step = 6 x {cfg.param_count() / 1e9:.3f} "
        f"B params x {TRAIN_GB * TRAIN_SEQ} tokens / {PEAK_FLOPS:.3g} FLOP/s "
        f"(launch/roofline.ideal_step_s)  [{smi}]")

    # the mq and tgb arms read the same grids, so from one state they train
    # to the same bits; the colocated arm reads the pool's own order
    for depth in FIG17_DEPTHS:
        a, b = arms[("mq", depth)], arms[("tgb", depth)]
        if a["losses"] != b["losses"]:
            raise AssertionError(f"fused depth {depth}: mq losses {a['losses']} are not "
                                 f"tgb's {b['losses']}")
    log(f"fused: the mq and tgb arms' {FUSED_WARMUP + FUSED_TIMED} losses are bit-identical "
        f"at each depth (depth 0 {arms[('tgb', 0)]['losses'][:3]} ...)")

    # benchmarks/check_fig17.py's gates
    tps = {k: v["tokens_per_s"] for k, v in arms.items()}
    wait = {k: v["attr"]["data_wait"] for k, v in arms.items()}
    ratios = [v["attr"]["compute_vs_roofline"] for v in arms.values()]
    gates = [
        (f"tgb d2 data_wait {wait[('tgb', 2)]:.4f} < {FIG17_MAX_DATA_WAIT}",
         wait[("tgb", 2)] < FIG17_MAX_DATA_WAIT),
        (f"tgb d2 {tps[('tgb', 2)]:.1f} tokens/s >= {FIG17_VS_COLOCATED} x colocated d2 "
         f"{tps[('colocated', 2)]:.1f}", tps[("tgb", 2)] >= FIG17_VS_COLOCATED * tps[("colocated", 2)]),
        (f"tgb d2 {tps[('tgb', 2)]:.1f} tokens/s >= {FIG17_VS_DEPTH0} x tgb d0 "
         f"{tps[('tgb', 0)]:.1f}", tps[("tgb", 2)] >= FIG17_VS_DEPTH0 * tps[("tgb", 0)]),
        (f"tgb d0 data_wait {wait[('tgb', 0)]:.4f} >= d2's + {FIG17_WAIT_DROP}",
         wait[("tgb", 0)] >= wait[("tgb", 2)] + FIG17_WAIT_DROP),
        (f"compute_vs_roofline {min(ratios):.3f}..{max(ratios):.3f} within "
         f"{FIG17_ROOFLINE_SPREAD}x", max(ratios) <= FIG17_ROOFLINE_SPREAD * min(ratios)),
    ]
    log("fused: check_fig17's gates: " + "; ".join(
        f"{text}: {'pass' if ok else 'FAIL'}" for text, ok in gates))
    if not all(ok for _, ok in gates):
        raise AssertionError("fused: check_fig17's gates failed")

    # the ring ran ahead; stop() rewound every reader to the consumed frontier
    tgb2 = arms[("tgb", 2)]
    steps_at = [ck.step for ck in tgb2["src"].cursors()]
    if steps_at != [tgb2["loop"].consumed] * topo.world:
        raise AssertionError(f"fused: reader cursors {steps_at} after stop(), "
                             f"want {tgb2['loop'].consumed} each")
    # replay from the snapshot taken before step 2's fetch
    src2 = tgb2["src"]
    src2.inner.restore(src2.snapshots[2])
    replay, bad, _, _ = drive(src2, 2, (3,), lambda i: host_grids[2 + i])
    if bad or [g.tobytes() for g in replay] != [g.tobytes() for g in tgb2["grids"][2:5]]:
        raise AssertionError(f"fused replay from step 2: {bad}")
    launches = dict(kcommon.launches)
    n_steps = len(arms) * (FUSED_WARMUP + FUSED_TIMED) + FUSED_PROFILED + 3
    expect_all = {k: v * n_steps for k, v in want.items()}
    if launches != expect_all:
        raise AssertionError(f"fused: launches {launches} over {n_steps} steps, "
                             f"want {expect_all}")
    log(f"fused: replay of steps 2-4 from a cursor snapshot byte-identical; reader cursors "
        f"at the consumed frontier {steps_at}; launches over {n_steps} steps {launches} "
        f"({want} a step)")

    # negative control: the same checks refuse DP halves swapped
    _, bad, _, _ = drive(GridSource(fan_in("tgb"), swap_dp_halves=True), 2, (1,),
                         host_grids.__getitem__)
    if not bad:
        raise AssertionError("fused control (DP halves swapped): the grid check passed it")
    log(f"  control fused (DP halves swapped): refused ({bad[0]})")
    for session in sessions.values():
        session.close()
    return launches


def leaf_fingerprints(torch, tree):
    """Two int64 checksums of each leaf's bits, computed on the card: their
    sum and their sum weighted by (position mod 65521) + 1, so a moved or
    changed element changes the pair. Returns [(path, sum, weighted)]."""
    from repro_torch.models.common import tree_leaves

    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    piece = 1 << 26
    sums = []
    for leaf in tree_leaves(tree):
        bits = leaf.detach().reshape(-1).view(ints[leaf.element_size()])
        s = torch.zeros(2, dtype=torch.int64, device=leaf.device)
        for off in range(0, bits.numel(), piece):
            x = bits[off:off + piece].to(torch.int64)
            w = torch.arange(off, off + x.numel(), device=leaf.device) % 65521 + 1
            s[0] += x.sum()
            s[1] += (x * w).sum()
        sums.append(s)
    values = torch.stack(sums).tolist()
    return [(p, a, b) for p, (a, b) in zip(leaf_paths(tree), values)]


def mem_available_gib() -> float:
    """The host's MemAvailable, from /proc/meminfo."""
    for line in Path("/proc/meminfo").read_text().splitlines():
        if line.startswith("MemAvailable:"):
            return int(line.split()[1]) * 1024 / 2**30
    raise RuntimeError("no MemAvailable in /proc/meminfo")


def phase_resume(torch, kcommon, cfg, smi):
    """The granite-8b cut of phases 6 and 9, trained off a ``TrainSession``:
    an aligned checkpoint through ``FusedTrainLoop.aligned_checkpoint``, a
    kill between a later upload and its commit, and ``TrainSession.resume``
    + ``restore_model`` at full width. Returns the phase's launches."""
    import gc

    import numpy as np

    from repro_torch.core import FaultInjector, InjectedCrash, MemoryObjectStore
    from repro_torch.core.lifecycle import read_trim_marker
    from repro_torch.dataplane import Topology
    from repro_torch.models import init_params, param_specs
    from repro_torch.models.common import tree_leaves
    from repro_torch.obs.tracer import disable_tracing, enable_tracing
    from repro_torch.ops import fsck
    from repro_torch.run import TrainSession
    from repro_torch.train import (OptimizerConfig, StepConfig, init_opt_state,
                                   make_train_step)
    from repro_torch.train.checkpoint import load_model_state
    from repro_torch.train.pipeline import FusedTrainLoop, ReaderFanInSource

    def say(msg):
        log(f"resume: {msg}  [{smi}]")

    t_phase = time.monotonic()
    say(f"host MemAvailable {mem_available_gib():.2f} GiB at the start")
    topo = Topology(dp=FUSED_DP, cp=FUSED_CP, global_batch=TRAIN_GB, seq_len=TRAIN_SEQ)
    stream = fused_stream(np, cfg)
    store = MemoryObjectStore(faults=FaultInjector())   # no latency model
    session = TrainSession(store, topo, namespace=RESUME_NS)
    with session.writer("w0") as w:
        w.write_tokens(stream)

    def fan_in(sess):
        return ReaderFanInSource([sess.reader(dp_rank=d, cp_rank=c, prefetch_depth=4)
                                  for d in range(topo.dp) for c in range(topo.cp)], topo)

    step = make_train_step(cfg, OptimizerConfig(**TRAIN_OPT), StepConfig(microbatches=1))
    want = expected_train_launches(cfg)
    per_step = []

    def counted_step(p, o, batch):
        before = dict(kcommon.launches)
        out = step(p, o, batch)
        per_step.append({k: kcommon.launches[k] - before[k] for k in before})
        return out

    def new_loop(sess, params, opt):
        return FusedTrainLoop(fan_in(sess), counted_step, params, opt, topology=topo,
                              depth=2, timeout_s=60.0)

    def timed_checkpoint(loop, sess):
        tracer = enable_tracing()
        try:
            t0 = time.perf_counter()
            try:
                return loop.aligned_checkpoint(
                    sess, {"params": loop.params, "opt": loop.opt_state}), None
            except InjectedCrash as e:
                # its message only: the traceback's frames hold the state
                return None, str(e)
        finally:
            wall = time.perf_counter() - t0
            disable_tracing()
            spans = {s.name: s.dur for s in tracer.spans() if s.name.startswith("checkpoint.")}
            timings.append((wall, spans))

    params = init_params(param_specs(cfg), seed=SEED, device="cuda")
    opt = init_opt_state(params)
    state_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves({"params": params, "opt": opt}))
    say(f"state {state_bytes / 1e9:.3f} GB (fp32 params, m and v of {cfg.param_count() / 1e9:.3f} "
        f"B params, 12 B a param, and the step); {FUSED_BATCHES} TGBs of {TRAIN_GB} x "
        f"{TRAIN_SEQ} tokens in a MemoryObjectStore with no latency model")
    timings, peaks = [], {}

    def stage_peak(name):
        """Peak device memory of the stage that ends here (GiB)."""
        torch.cuda.synchronize()
        peaks[name] = torch.cuda.max_memory_allocated() / 2**30
        torch.cuda.reset_peak_memory_stats()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kcommon.reset_launches()

    # -- run A: 4 steps, the aligned checkpoint, 3 more steps, the kill -------------------
    loop = new_loop(session, params, opt)
    loop.start()
    losses_a = list(loop.run(4).losses)
    entry, _ = timed_checkpoint(loop, session)
    if entry.step != 4:
        raise AssertionError(f"resume: the aligned checkpoint bound step {entry.step}, want 4")
    bound = leaf_fingerprints(torch, {"params": loop.params, "opt": loop.opt_state})
    session.reclaim()
    trim = read_trim_marker(session.ns)
    grids_a = []
    losses_a += loop.run(3, on_batch=lambda i, t: grids_a.append(t.tobytes())).losses
    store.faults.crash_on("cput", key_substr=".rm", nth=1)
    killed, crash = timed_checkpoint(loop, session)
    if crash is None:
        raise AssertionError("resume: the second aligned checkpoint committed; want the "
                             "injected crash between its upload and its commit")
    store.faults = None
    (up_s, up_spans), (kill_s, kill_spans) = timings
    say(f"aligned checkpoint at step {entry.step} (seq {entry.seq}, {entry.model_key}); "
        f"upload {up_spans['checkpoint.upload']:.3f} s = "
        f"{state_bytes / up_spans['checkpoint.upload'] / 1e9:.3f} GB/s; commit "
        f"{up_spans['checkpoint.commit'] * 1e3:.3f} ms; aligned_checkpoint {up_s:.3f} s; "
        f"reclaim -> trim marker {trim}")
    say(f"killed checkpoint at step 7: {crash}; its upload {kill_spans['checkpoint.upload']:.3f} s "
        f"= {state_bytes / kill_spans['checkpoint.upload'] / 1e9:.3f} GB/s landed, no commit; "
        f"store holds {store.total_bytes() / 1e9:.3f} GB; host MemAvailable "
        f"{mem_available_gib():.2f} GiB")
    say(f"S3-class arithmetic (LatencyModel's put 300 MB/s, get 500 MB/s; not measured): "
        f"{state_bytes / 300e6:.1f} s up, {state_bytes / 500e6:.1f} s down")
    orphan_key = session.ns.key("checkpoints", f"{7:010d}", "MANIFEST.ckpt")
    if not store.exists(orphan_key):
        raise AssertionError(f"resume: the killed upload is not at {orphan_key}")

    # -- the crash: stop, close, free the trainer's state --------------------------------
    loop.stop()
    session.close()
    del loop, params, opt
    gc.collect()
    torch.cuda.empty_cache()
    stage_peak("run A")

    # -- run B: resume from the RunManifest, restore, replay 3 steps ---------------------
    params = init_params(param_specs(cfg), seed=SEED + 1, device="cuda")
    template = {"params": params, "opt": init_opt_state(params)}
    del params
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    resumed = TrainSession.resume(store, RESUME_NS)
    state = resumed.restore_model(template)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    del template
    gc.collect()
    stage_peak("template + restore")
    if resumed.resume_step != 4:
        raise AssertionError(f"resume: resume_step {resumed.resume_step}, want 4")
    got = leaf_fingerprints(torch, state)
    moved = [p for (p, *a), (_, *b) in zip(got, bound) if a != b]
    say(f"TrainSession.resume + restore_model {restore_s:.3f} s = "
        f"{state_bytes / restore_s / 1e9:.3f} GB/s; resume_step {resumed.resume_step}; "
        f"leaves bit-identical to the bound state: {len(got) - len(moved)} of {len(got)}")
    if moved:
        raise AssertionError(f"resume: restored leaves differ from the bound state: {moved}")
    grids_b, first_step_end = [], []

    def on_batch_b(i, t):
        grids_b.append(t.tobytes())
        first_step_end.append(time.perf_counter())

    loop = new_loop(resumed, state["params"], state["opt"])
    with loop:
        losses_b = loop.run(3, on_batch=on_batch_b).losses
    del state
    stage_peak("resumed steps")
    rel = [abs(b - a) / abs(a) for a, b in zip(losses_a[4:], losses_b)]
    say(f"resume to the end of the first resumed step {first_step_end[0] - t0:.3f} s; "
        f"run A steps 5-7 losses {losses_a[4:]}; resumed {losses_b}; largest relative "
        f"difference {max(rel):.3e} (limit {RESUME_LOSS_RTOL:g}); grids byte-identical: "
        f"{grids_b == grids_a}")
    if grids_b != grids_a or max(rel) > RESUME_LOSS_RTOL:
        raise AssertionError("resume: the resumed steps are not run A's steps 5-7")

    # -- negative control: the orphan upload with the aligned cursor ---------------------
    orphan, _ = load_model_state(resumed.ns, orphan_key,
                                 {"params": loop.params, "opt": loop.opt_state})
    resumed.close()
    del loop
    gc.collect()
    stage_peak("orphan load")
    control = TrainSession.resume(store, RESUME_NS)
    loop = new_loop(control, orphan["params"], orphan["opt"])
    with loop:
        loss_c = loop.run(1).losses[0]
    control.close()
    del loop, orphan
    gc.collect()
    stage_peak("control step")
    off = abs(loss_c - losses_a[4]) / abs(losses_a[4])
    if off <= RESUME_LOSS_RTOL:
        raise AssertionError("resume control (the orphan upload with the aligned cursor): "
                             "the loss check passed it")
    say(f"control (the killed step-7 upload with the step-4 cursor): loss {loss_c:.6f} vs "
        f"{losses_a[4]:.6f}, relative difference {off:.3e} = {off / RESUME_LOSS_RTOL:.3g}x "
        f"the limit: refused")

    # -- fsck -------------------------------------------------------------------------
    report = fsck(session.ns)
    kinds = {i.kind: i for i in report.issues}
    say(f"{report.summary()}; " + "; ".join(str(i) for i in report.issues))
    if any(i.severity == "error" for i in report.issues) or not (
            "pending-model-checkpoint" in kinds or "orphan-model-checkpoint" in kinds):
        raise AssertionError("resume: fsck reports an error or misses the killed upload")

    launches = dict(kcommon.launches)
    bad = [i for i, n in enumerate(per_step) if n != want]
    say(f"launches over {len(per_step)} steps {launches}; a step {per_step[0]} (want {want}); "
        f"max_memory_allocated {max(peaks.values()):.2f} GiB (by stage: "
        + ", ".join(f"{k} {v:.2f}" for k, v in peaks.items()) + f" GiB); phase "
        f"{time.monotonic() - t_phase:.1f} s")
    if bad or len(per_step) != 11:
        raise AssertionError(f"resume: steps {bad} launched other than {want}")
    return launches


def phase_failure(torch, kcommon, cfg, smi):
    """Phase 11, failure isolation and a brownout with a live producer
    thread, on the cut of phase 9 at depth 2: (a) the colocated pool dies
    and the trainer stalls; (b) a tgb producer dies, a replacement recovers
    from the manifest, and the trainer runs on exactly once; (c) the tgb arm
    rides out fig16's SlowDown storm behind the resilient client with
    grids and losses bit-identical to a fault-free run from the same state.
    Returns the phase's launches."""
    import threading

    import numpy as np

    from repro_torch.core import (BatchTimeout, BrownoutPhase, FaultPolicy,
                                  FaultyObjectStore, HedgePolicy, LatencyModel,
                                  MemoryObjectStore, Namespace, ResilienceConfig,
                                  run_producer_loop)
    from repro_torch.data.packing import GlobalBatchPacker
    from repro_torch.dataplane import Topology, open_dataplane
    from repro_torch.models import init_params, param_specs
    from repro_torch.obs.recorder import latest_snapshot
    from repro_torch.obs.registry import default_registry
    from repro_torch.train import (OptimizerConfig, StepConfig, init_opt_state,
                                   make_train_step)
    from repro_torch.train.pipeline import FusedTrainLoop, ReaderFanInSource

    def say(msg):
        log(f"failure: {msg}  [{smi}]")


    t_phase = time.monotonic()
    topo = Topology(dp=FUSED_DP, cp=FUSED_CP, global_batch=TRAIN_GB, seq_len=TRAIN_SEQ)
    stream = fused_stream(np, cfg)
    host_grids = packer_grids(np, topo, stream)
    slices = [b.slices for b in GlobalBatchPacker(TRAIN_GB, TRAIN_SEQ, topo.dp, topo.cp)
              .add_tokens(stream)]
    params = init_params(param_specs(cfg), seed=SEED, device="cuda")
    opt = init_opt_state(params)
    saved = [t.clone() for t in state_leaves(params, opt)]
    step = make_train_step(cfg, OptimizerConfig(**TRAIN_OPT), StepConfig(microbatches=1))
    want = expected_train_launches(cfg)
    per_step = []

    def counted_step(p, o, batch):
        before = dict(kcommon.launches)
        out = step(p, o, batch)
        per_step.append({k: kcommon.launches[k] - before[k] for k in before})
        return out

    def fan_in(session):
        return ReaderFanInSource([session.reader(dp_rank=d, cp_rank=c, prefetch_depth=4)
                                  for d in range(topo.dp) for c in range(topo.cp)], topo)

    def train(src, inject=None, timeout_s=60.0):
        """The harness of every case: FAILURE_STEPS steps of a depth-2 loop
        over ``src``, one ``run`` at a time, ``inject()`` after step
        CRASH_AFTER_STEP. Returns (grids, step timings, the end time of
        each step, the error that stopped the loop or None)."""
        nonlocal params, opt
        grids, timings, ends, err = [], [], [], None
        loop = FusedTrainLoop(src, counted_step, params, opt, topology=topo, depth=2,
                              timeout_s=timeout_s)
        with loop:
            for i in range(FAILURE_STEPS):
                try:
                    timings += loop.run(1, on_batch=lambda _, g: grids.append(g.copy())).timings
                except BatchTimeout as e:
                    err = e
                    break
                ends.append(time.monotonic())
                if inject is not None and i + 1 == CRASH_AFTER_STEP:
                    inject()
        params, opt = loop.params, loop.opt_state
        return grids, timings, ends, err

    def isolation_faults(grids, want_grids, err):
        """What breaks the isolation claim: an error, a missing step, a grid
        that is not the host packer's (repeated, skipped or torn)."""
        faults = [] if err is None else [f"{type(err).__name__}: {err}"]
        if len(grids) < FAILURE_STEPS:
            faults.append(f"{len(grids)} of {FAILURE_STEPS} steps ran")
        faults += [f"grid {i} is not the packer's" for i, (g, w) in
                   enumerate(zip(grids, want_grids)) if not np.array_equal(g, w)]
        return faults

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kcommon.reset_launches()
    t_case = [time.monotonic()]

    def case_s():
        """Seconds since the previous case ended (the first: since the state
        was made)."""
        now = time.monotonic()
        dt, t_case[0] = now - t_case[0], now
        return dt

    say(f"state and its saved copy made in {t_case[0] - t_phase:.1f} s")

    # -- (a) the colocated pool dies after step 3: the trainer stalls ----------------------
    src, writer, pulled, grid_of = colocated_source(np, topo, cfg.vocab_size)
    crash_at = []

    def crash():
        crash_at.append(time.monotonic())
        writer.inject_crash()

    try:
        grids, timings, ends, err = train(src, inject=crash, timeout_s=CRASH_TIMEOUT_S)
    finally:
        writer.__exit__(None, None, None)
    faults = isolation_faults(grids, [grid_of(ix) for ix in pulled], err)
    stall = time.monotonic() - ends[-1] if ends else float("nan")
    say(f"(a) colocated crash after step {CRASH_AFTER_STEP}: {len(grids)} steps ran "
        f"({len(grids) - CRASH_AFTER_STEP} from the ring and queue after the crash), then "
        f"{type(err).__name__} {stall:.2f} s after the last step (loop timeout "
        f"{CRASH_TIMEOUT_S} s); the isolation check refuses it: {faults[:2]}; case "
        f"{case_s():.1f} s")
    if not isinstance(err, BatchTimeout) or not faults or \
            not CRASH_TIMEOUT_S <= stall <= CRASH_TIMEOUT_S + 3.0:
        raise AssertionError("failure (a): the colocated crash did not stall the trainer "
                             "into a BatchTimeout within the loop's timeout")

    # -- (b) a tgb producer dies after 5 TGBs; a replacement recovers ------------------------
    kill_store = MemoryObjectStore(latency=LatencyModel())
    session = open_dataplane(kill_store, topo, namespace="runs/kill",
                             obs_snap_interval_s=OBS_SNAP_S)
    events = {}

    class Killed(Exception):
        pass

    def first_payload(offset):
        if offset == KILL_AFTER_TGBS:
            raise Killed()
        return slices[offset]

    def producers():
        w1 = session.writer("w0").__enter__()
        events["killed"] = w1.producer.stats.metric_scope
        try:
            run_producer_loop(w1.producer, FUSED_BATCHES, 0, produce_delay_s=PRODUCE_DELAY_S,
                              payload_fn=first_payload)
        except Killed:   # the thread dies; its writer is never finalized
            events["kill"] = time.monotonic()
            events["pending"] = len(w1.producer.pending)
        time.sleep(RESTART_S)
        w2 = session.writer("w0").__enter__()   # recover() from the manifest
        events["recovered"] = (time.monotonic(), w2.recovered_offset)
        events["replacement"] = w2.producer.stats.metric_scope
        run_producer_loop(w2.producer, FUSED_BATCHES - w2.recovered_offset, 0,
                          produce_delay_s=PRODUCE_DELAY_S, payload_fn=slices.__getitem__)
        events["done"] = time.monotonic()

    t0 = time.monotonic()
    thread = threading.Thread(target=producers, name="tgb-producers")
    thread.start()
    grids, timings, ends, err = train(fan_in(session))
    thread.join(timeout=60.0)
    faults = isolation_faults(grids, host_grids, err)
    t_kill, (t_rec, recovered) = events.get("kill", float("nan")), events["recovered"]
    near = [i for i, e in enumerate(ends) if e >= t_kill and e - timings[i].wall_s <= t_rec + 1.0]
    view = session.manifest_view()
    seqs = [t.producer_seq for t in view.tgbs]
    say(f"(b) tgb producer killed before TGB {KILL_AFTER_TGBS} at {t_kill - t0:.2f} s "
        f"({events.get('pending')} written but uncommitted); the replacement entered "
        f"{t_rec - t_kill:.2f} s later and recovered offset {recovered}; the trainer ran "
        f"{len(grids)} of {FAILURE_STEPS} steps, every grid the host packer's, once: "
        f"{not faults}; manifest seqs {seqs}; data_wait ms by step "
        f"{[round(t.data_wait_s * 1e3, 2) for t in timings]}, the steps around the kill "
        f"{near} ({[round(timings[i].data_wait_s * 1e3, 2) for i in near]}); case "
        f"{case_s():.1f} s")
    session.close()
    if faults or seqs != list(range(FUSED_BATCHES)) or thread.is_alive():
        raise AssertionError(f"failure (b): the trainer did not run on exactly once past "
                             f"the producer kill: {faults[:3]}; seqs {seqs}")
    say(f"(b) {postmortem(kill_store, 'runs/kill', events['killed'], events['replacement'])}")

    # -- (c) fig16's SlowDown storm over the middle third of the run -------------------------
    def resilient_config(seed):
        """benchmarks/fig16_brownout.py's ``_resilient_config``."""
        return ResilienceConfig(
            seed=seed, base_delay_s=0.005, backoff_cap_s=0.1,
            retry_budgets={"read": (32.0, 8.0), "write": (32.0, 8.0),
                           "control": (32.0, 8.0)},
            hedge=HedgePolicy(quantile=0.9, min_samples=16, min_delay_s=0.002),
            breaker_failure_threshold=10, breaker_cooldown_s=0.1,
            governor_md_factor=0.8, governor_ai_per_s=10.0,
            governor_min_rate=8.0, governor_idle_reset_s=0.5)

    # the fault-free run from the saved state
    restore_state(torch, params, opt, saved)
    clean = open_dataplane(MemoryObjectStore(latency=LatencyModel()), topo, namespace="runs/clean")
    with clean.writer("w0") as w:
        w.write_tokens(stream)
    t0 = time.monotonic()
    ref_grids, ref_timings, _, err = train(fan_in(clean))
    ref_wall = time.monotonic() - t0
    clean.close()
    if err is not None:
        raise AssertionError(f"failure (c): the fault-free run failed: {err}")

    # the same steps from the same state through the storm
    restore_state(torch, params, opt, saved)
    inner = MemoryObjectStore(latency=LatencyModel())
    faulty = FaultyObjectStore(inner, FaultPolicy(seed=0, slow_get_rate=0.15, slow_get_s=0.06,
                                                  key_filter="/tgb/"))
    session = open_dataplane(faulty, topo, namespace="runs/brownout",
                             resilience=resilient_config(0), obs_snap_interval_s=OBS_SNAP_S)
    writer = session.writer("w0", spill_limit=256).__enter__()
    for offset in range(BROWNOUT_WARMUP_TGBS):
        writer.write(slices[offset])
    writer.flush()
    thread = threading.Thread(target=run_producer_loop, name="tgb-producer", kwargs=dict(
        producer=writer.producer, n_tgbs=FUSED_BATCHES - BROWNOUT_WARMUP_TGBS, slice_bytes=0,
        produce_delay_s=PRODUCE_DELAY_S, payload_fn=slices.__getitem__))
    third = ref_wall / 3
    t0 = faulty.script_brownout([BrownoutPhase(third, 2 * third, target_rate=120.0,
                                               retry_after_s=0.1)])
    thread.start()
    grids, timings, ends, err = train(fan_in(session))
    faulty.clear_brownout()
    thread.join(timeout=60.0)
    wall = time.monotonic() - t0
    losses, ref_losses = [t.loss for t in timings], [t.loss for t in ref_timings]
    same = (err is None and len(grids) == len(ref_grids)
            and all(np.array_equal(a, b) for a, b in zip(grids, ref_grids)) and losses == ref_losses)
    shares = []
    for k in range(3):
        idx = [i for i, e in enumerate(ends) if min(2, int((e - t0) // third)) == k]
        w = sum(timings[i].wall_s for i in idx)
        shares.append((len(idx), sum(timings[i].data_wait_s for i in idx) / w if w else 0.0))
    rs = session.store.resilience
    prod = writer.producer
    scope = prod.stats.metric_scope
    snap = latest_snapshot(Namespace(inner, "runs/brownout"), scope)
    if snap is None or snap["metrics"] != default_registry().snapshot(scope + "."):
        # the last word was shed by the storm (telemetry never retries
        # inline): the recorder's next heartbeat, after the storm, lands it
        prod._recorder.snap()
        snap = latest_snapshot(Namespace(inner, "runs/brownout"), scope)
    live = default_registry().snapshot(scope + ".")
    top_c, store_row, cli_ms_c = store_row_from_storage(inner, "runs/brownout", session.store)
    store_scope, cli_throttled = rs.metric_scope, store_row["metrics"].get("throttled")
    say(f"(c) brownout: storm [{third:.2f}, {2 * third:.2f}) s of a {wall:.2f} s run (the "
        f"fault-free run took {ref_wall:.2f} s); throttles seen {rs.throttled}, injected "
        f"{faulty.fault_stats.counts.get('throttled', 0)}, slow GETs "
        f"{faulty.fault_stats.counts.get('slow_get', 0)}; retries {rs.retries}, Retry-After "
        f"paused {rs.throttle_pause_s:.2f} s, governor delay {rs.governor_delay_s:.2f} s, "
        f"hedges fired {rs.hedges_fired} won {rs.hedges_won}, breaker opens "
        f"{rs.breaker_opens}; producer spilled {prod.stats.tgbs_spilled}, replayed "
        f"{prod.stats.spill_replayed}; data_wait share by third (steps, share) "
        f"{[(n, round(x, 4)) for n, x in shares]}; grids and losses bit-identical to the "
        f"fault-free run: {same}")
    say(f"(c) flight recorder: {scope} published {prod._recorder.published}, dropped "
        f"{prod._recorder.dropped}; latest snapshot seq {snap and snap['seq']} from "
        f"runs/brownout/obs/ equals the live registry: {snap is not None and snap['metrics'] == live} "
        f"(tgbs_written {live.get(scope + '.tgbs_written')}, commit_successes "
        f"{live.get(scope + '.commit_successes')})")
    say(f"(c) top over runs/brownout ({cli_ms_c[0]:.1f} ms; obs --json {cli_ms_c[1]:.1f} ms): "
        f"{[line.strip() for line in top_c.splitlines()[2:]]}; obs --json {store_scope} "
        f"throttled {cli_throttled}, the live registry's {rs.throttled}: "
        f"{cli_throttled == rs.throttled} (breaker {store_row.get('breaker')}, hedge win rate "
        f"{store_row.get('hedge_win_rate')}); case {case_s():.1f} s")
    session.close()
    if not same or rs.throttled <= 0 or thread.is_alive() or snap is None \
            or snap["metrics"] != live or cli_throttled != rs.throttled:
        raise AssertionError(f"failure (c): bit-identical {same}, throttles seen "
                             f"{rs.throttled} ({cli_throttled} in obs --json), snapshot "
                             f"equals the registry {snap is not None and snap['metrics'] == live}")

    launches = dict(kcommon.launches)
    bad = [i for i, n in enumerate(per_step) if n != want]
    say(f"launches over {len(per_step)} steps {launches}; a step {per_step[0]} (want {want}); "
        f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; phase "
        f"{time.monotonic() - t_phase:.1f} s")
    if bad:
        raise AssertionError(f"failure: steps {bad} launched other than {want}")
    return launches


def phase_streams(torch, kcommon, cfg, smi):
    """Phase 12: the cut of phase 9 (dp 2 x cp 1) trained off a weighted mix
    of a live raw stream, a stream sharded into CODE_SHARDS manifest chains
    and a stream derived live from the raw one, whose derive worker is
    killed between an upload and its cursor commit; a composite aligned
    checkpoint, a compactor cycle, the resume and its negative controls,
    fsck. Returns the phase's launches."""
    import dataclasses
    import gc
    import threading

    import numpy as np

    from repro_torch.core import (Compactor, Consumer, FaultInjector, InjectedCrash,
                                  MemoryObjectStore, MeshPosition, Namespace,
                                  open_manifest_store, read_trim_marker,
                                  run_producer_loop)
    from repro_torch.data.packing import GlobalBatchPacker, assemble_grid
    from repro_torch.dataplane import Topology
    from repro_torch.graph import FilterOp, OpGraph, PackOp
    from repro_torch.models import init_params, param_specs
    from repro_torch.models.common import tree_leaves
    from repro_torch.obs.tracer import disable_tracing, enable_tracing
    from repro_torch.ops import fsck, inspect_run
    from repro_torch.run import TrainSession
    from repro_torch.streams import MixPlan
    from repro_torch.train import (OptimizerConfig, StepConfig, init_opt_state,
                                   make_train_step)
    from repro_torch.train.pipeline import FusedTrainLoop, ReaderFanInSource

    def say(msg):
        log(f"streams: {msg}  [{smi}]")

    t_phase = time.monotonic()
    topo = Topology(dp=FUSED_DP, cp=STREAM_CP, global_batch=TRAIN_GB, seq_len=TRAIN_SEQ)
    plan = MixPlan(STREAM_WEIGHTS, seed=MIX_SEED)
    need = plan.stream_counts(STREAM_STEPS + STREAM_LOOKAHEAD)
    grid_tokens = TRAIN_GB * TRAIN_SEQ

    def packed(tokens, flush=False):
        """The host packer's grids (and slices) of ``tokens``."""
        packer = GlobalBatchPacker(TRAIN_GB, TRAIN_SEQ, topo.dp, topo.cp)
        batches = packer.add_tokens(tokens)
        tail = packer.flush() if flush else None
        batches += [tail] if tail is not None else []
        return ([assemble_grid(b.slices, TRAIN_GB, TRAIN_SEQ, topo.dp, topo.cp)
                 for b in batches], [b.slices for b in batches])

    def keep_even(rows):
        return rows[:, 0] % 2 == 0

    # -- the host's data: web and code grids, and the host's own derivation --------------
    rng = np.random.default_rng(SEED + 12)
    web_grids, _ = packed(rng.integers(0, cfg.vocab_size, 64 * grid_tokens).astype(np.int32))
    derived, n_src = [], 0
    # enough windows for the mix, and a window after the replayed one
    while len(derived) < need["filtered"] or n_src < 3 * DERIVE_WINDOW:
        rows = np.concatenate([g[keep_even(g)] for g in web_grids[n_src:n_src + DERIVE_WINDOW]])
        derived += packed(rows.ravel(), flush=True)[0]
        n_src += DERIVE_WINDOW
    n_web = max(need["web"], n_src)
    web_grids, web_slices = packed(np.concatenate(web_grids[:n_web]).ravel())
    code_grids, code_slices = {}, {}
    for i, pid in enumerate(("p0", "p1")):
        n = (need["code"] + 1 - i) // 2 + 1
        toks = np.random.default_rng(SEED + 13 + i).integers(0, cfg.vocab_size, n * grid_tokens)
        code_grids[pid], code_slices[pid] = packed(toks.astype(np.int32))

    # -- the run: the store, the sharded claim, the session, the live writers ------------
    store = MemoryObjectStore(faults=FaultInjector())     # no latency model
    run_ns = Namespace(store, STREAMS_NS)
    open_manifest_store(run_ns.stream("code"), shards=CODE_SHARDS)  # before any write
    session = TrainSession(store, topo, namespace=STREAMS_NS, streams=STREAM_WEIGHTS,
                           mix_seed=MIX_SEED)
    errors = []

    def produce(stream, writer_id, slices):
        try:
            with session.writer(writer_id, stream=stream) as w:
                run_producer_loop(w.producer, len(slices), 0, produce_delay_s=PRODUCE_DELAY_S,
                                  payload_fn=slices.__getitem__)
        except BaseException as e:   # noqa: BLE001 - reported and raised below
            errors.append(f"{stream}/{writer_id}: {type(e).__name__}: {e}")

    graph = OpGraph("keep-even-first")
    graph.add(FilterOp("keep-even", keep_even), source="web", output="rows")
    graph.add(PackOp("pack", global_batch=TRAIN_GB, seq_len=TRAIN_SEQ, dp=topo.dp,
                     cp=topo.cp), source="rows", output="filtered")
    derive = {}

    def derive_live():
        """The derive worker, killed by the FaultInjector at its second
        window's cursor commit; a replacement DERIVE_RESTART_S later replays
        that window from the committed cursor, then derives the rest."""
        try:
            w1 = session.data.derive_worker(graph, window_steps=DERIVE_WINDOW)
            try:
                w1.run(max_source_steps=n_src, timeout_s=60.0)
            except InjectedCrash as e:
                derive["kill"] = (time.monotonic(), str(e))
            derive["before"] = (w1.stats.tgbs_derived, w1.stats.tgbs_derived
                                - w1.stats.store_hits, w1.stats.store_hits, w1.stats.windows)
            time.sleep(DERIVE_RESTART_S)
            w2 = session.data.derive_worker(graph, window_steps=DERIVE_WINDOW)
            derive["resumed_at"] = w2.recover()
            w2.derive_window(w2.src_step + DERIVE_WINDOW, timeout_s=60.0)
            derive["replay"] = (w2.stats.tgbs_derived, w2.stats.store_hits)
            w2.run(max_source_steps=n_src, timeout_s=60.0)
            derive["after"] = (w2.stats.tgbs_derived, w2.stats.tgbs_derived
                               - w2.stats.store_hits, w2.stats.store_hits, w2.stats.windows)
        except BaseException as e:   # noqa: BLE001 - reported and raised below
            errors.append(f"derive: {type(e).__name__}: {e}")

    store.faults.crash_on("cput", key_substr=f"{STREAMS_NS}/streams/filtered/derive/", nth=2)
    threads = [threading.Thread(target=produce, args=("web", "w0", web_slices), name="web"),
               threading.Thread(target=produce, args=("code", "p0", code_slices["p0"]),
                                name="code-p0"),
               threading.Thread(target=produce, args=("code", "p1", code_slices["p1"]),
                                name="code-p1"),
               threading.Thread(target=derive_live, name="derive")]

    step = make_train_step(cfg, OptimizerConfig(**TRAIN_OPT), StepConfig(microbatches=1))
    want = expected_train_launches(cfg)
    per_step, device_tokens = [], []

    def checked_step(p, o, batch):
        device_tokens.append(batch["tokens"].clone())
        before = dict(kcommon.launches)
        out = step(p, o, batch)
        per_step.append({k: kcommon.launches[k] - before[k] for k in before})
        return out

    def fan_in(sess):
        return ReaderFanInSource([sess.reader(dp_rank=d, cp_rank=c, prefetch_depth=4)
                                  for d in range(topo.dp) for c in range(topo.cp)], topo)

    def new_loop(sess, params, opt):
        return FusedTrainLoop(fan_in(sess), checked_step, params, opt, topology=topo,
                              depth=2, timeout_s=60.0)

    params = init_params(param_specs(cfg), seed=SEED, device="cuda")
    opt = init_opt_state(params)
    state_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves({"params": params, "opt": opt}))
    say(f"mix {plan} over {STREAM_STEPS} steps: {plan.stream_counts(STREAM_STEPS)} steps a "
        f"stream; web {n_web} TGBs, code {sum(len(v) for v in code_slices.values())} (p0 "
        f"{len(code_slices['p0'])}, p1 {len(code_slices['p1'])}) into {CODE_SHARDS} shard "
        f"chains, filtered = keep-even-first > pack over web's first {n_src} TGBs in windows "
        f"of {DERIVE_WINDOW}: {len(derived)} grids by the host; dp {topo.dp} x cp {topo.cp} "
        f"(the derive worker reads whole rows only at cp 1), live producers "
        f"{PRODUCE_DELAY_S} s a TGB; state {state_bytes / 1e9:.3f} GB")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kcommon.reset_launches()

    # -- run A: steps 1-6, the composite checkpoint, reclaim, compaction, 7-14 ---------------
    t0 = time.monotonic()
    for t in threads:
        t.start()
    grids_a = []
    loop = new_loop(session, params, opt)
    loop.start()
    rep_a = [loop.run(STREAM_CKPT_STEP, on_batch=lambda i, g: grids_a.append(g.copy()))]
    # the writers and the derive worker finish while the ring stays staged; the
    # derived stream is read back whole before the reclaim can trim it
    for t in threads:
        t.join(timeout=60.0)
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"streams: a writer or the derive worker failed: {errors}")
    code_view = session.manifest_view("code")
    code_order = [code_view.tgb_at_step(k) for k in range(code_view.total_steps)]
    filtered_view = session.manifest_view("filtered")
    cons = Consumer(run_ns.stream("filtered"), MeshPosition(0, 0, 1, 1))
    got_filtered = [np.frombuffer(b"".join(cons.next_batch(timeout_s=5) for _ in range(topo.dp)),
                                  np.int32).reshape(TRAIN_GB, TRAIN_SEQ)
                    for _ in range(filtered_view.total_steps)]
    derived_same = (len(got_filtered) == len(derived)
                    and all(np.array_equal(a, b) for a, b in zip(got_filtered, derived)))
    tracer = enable_tracing()
    t_ck = time.perf_counter()
    entry = loop.aligned_checkpoint(session, {"params": loop.params, "opt": loop.opt_state})
    ck_s = time.perf_counter() - t_ck
    disable_tracing()
    spans = {s.name: s.dur for s in tracer.spans() if s.name.startswith("checkpoint.")}
    bound = leaf_fingerprints(torch, {"params": loop.params, "opt": loop.opt_state})
    token = entry.data_checkpoint()
    if entry.step != STREAM_CKPT_STEP or not token.composite \
            or token.mix_pos != STREAM_CKPT_STEP or entry.mix_seed != MIX_SEED:
        raise AssertionError(f"streams: the checkpoint bound step {entry.step}, token "
                             f"{token}, mix seed {entry.mix_seed}")
    deleted = session.reclaim()
    code_ns = run_ns.stream("code")
    trim = read_trim_marker(code_ns)
    safe_step = trim[0] if trim is not None else entry.watermark("code").step
    manifests = open_manifest_store(code_ns)
    compactor = Compactor(code_ns, manifests, min_fold=1)
    t_c = time.perf_counter()
    summary = compactor.run_cycle(safe_step=safe_step)
    compact_ms = (time.perf_counter() - t_c) * 1e3
    bases = [s.load_view(s.latest_version(hint=-1)).base_step for s in manifests.shards]
    seg = manifests.segments.read(summary["segment"]) if summary["segment"] >= 0 else None
    say(f"aligned checkpoint at step {entry.step} (seq {entry.seq}), composite token mix_pos "
        f"{token.mix_pos}, cursors {[tuple(r) for r in token.streams]}; upload "
        f"{spans['checkpoint.upload']:.3f} s = {state_bytes / spans['checkpoint.upload'] / 1e9:.3f} "
        f"GB/s, commit {spans['checkpoint.commit'] * 1e3:.3f} ms, aligned_checkpoint "
        f"{ck_s:.3f} s; reclaim deleted {deleted} TGBs; code trim marker {trim}")
    say(f"compactor on code at safe step {safe_step} ({'its trim marker' if trim else 'the checkpoint watermark'}): "
        f"folded {summary['folded']} entries into segment {summary['segment']} in "
        f"{compact_ms:.3f} ms; segment folds {seg and seg.folds}, shard bases {bases}; "
        f"{compactor.stats.trim_commits} trim commits")
    if summary["folded"] <= 0 or seg is None or bases != list(seg.folds):
        raise AssertionError(f"streams: the compactor folded {summary}, bases {bases}")
    rep_a.append(loop.run(STREAM_STEPS - STREAM_CKPT_STEP,
                          on_batch=lambda i, g: grids_a.append(g.copy())))
    loop.stop()
    wall_a = time.monotonic() - t0

    # every step's grid the one the host expects, its device tokens the host's
    host_of = {"web": web_grids, "filtered": derived,
               "code": [code_grids[d.producer_id][d.producer_seq] for d in code_order]}
    schedule = plan.schedule(STREAM_STEPS)
    expect = [host_of[name][k] for name, k in schedule]
    bad = [f"step {i + 1} ({name} {k}): not the host's grid"
           for i, ((name, k), g, w) in enumerate(zip(schedule, grids_a, expect))
           if not np.array_equal(g, w)]
    bad += [f"step {i + 1}: device tokens are not the host tokens"
            for i, (dev, g) in enumerate(zip(device_tokens, grids_a))
            if dev.dtype != torch.int32 or not np.array_equal(dev.cpu().numpy(), g)]
    med = statistics.median(t.wall_s for r in rep_a for t in r.timings)
    walls = sum(r.totals()["wall_s"] for r in rep_a)
    split = {k: sum(r.totals()[f"{k}_s"] for r in rep_a) / walls
             for k in ("data_wait", "h2d", "compute", "other")}
    kill_t, kill_msg = derive.get("kill", (float("nan"), None))
    say(f"run A: {len(grids_a)} steps in {wall_a:.2f} s; {grid_tokens / med:.1f} tokens/s at "
        f"the median step ({med * 1e3:.2f} ms); split data_wait {split['data_wait']:.4f} h2d "
        f"{split['h2d']:.4f} compute {split['compute']:.4f} other {split['other']:.4f}; "
        f"data_wait ms by step {[round(t.data_wait_s * 1e3, 2) for r in rep_a for t in r.timings]}; "
        f"streams by step {[name for name, _ in schedule]}; every grid the host's and every "
        f"step's device tokens the host's: {not bad}")
    say(f"derive worker: killed at {kill_t - t0:.2f} s ({kill_msg}); before the kill "
        f"(TGBs, uploads, hits, windows) {derive.get('before')}; the replacement "
        f"{DERIVE_RESTART_S} s later resumed at source step {derive.get('resumed_at')} and its "
        f"replayed window derived {derive.get('replay', (None,))[0]} TGBs with "
        f"{derive.get('replay', (0, None))[1]} hits = "
        f"{None if 'replay' not in derive else derive['replay'][0] - derive['replay'][1]} "
        f"uploads; after (TGBs, uploads, hits, windows) {derive.get('after')}; the filtered "
        f"stream ({filtered_view.total_steps} TGBs, read back before the reclaim) equals the "
        f"host's derivation byte for byte: {derived_same}")
    if bad or kill_msg is None or "replay" not in derive or derive["resumed_at"] != DERIVE_WINDOW \
            or derive["replay"][0] <= 0 or derive["replay"][0] != derive["replay"][1] \
            or not derived_same:
        raise AssertionError(f"streams run A: {bad[:4]}; derive {derive}; filtered equal "
                             f"{derived_same}")

    # -- the crash: stop, close, free the trainer's state --------------------------------
    losses_a = [t.loss for r in rep_a for t in r.timings]
    session.close()
    del loop, params, opt, device_tokens[:]
    gc.collect()
    torch.cuda.empty_cache()
    peak_a = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()

    # -- negative control (a): the run resumed with web's and code's weights swapped -------
    swapped = {**STREAM_WEIGHTS, "web": STREAM_WEIGHTS["code"], "code": STREAM_WEIGHTS["web"]}
    control = TrainSession.resume(store, STREAMS_NS, streams=swapped)
    try:
        control.reader(dp_rank=0, cp_rank=0)
        refused_a = None
    except ValueError as e:
        refused_a = str(e)
    control.close()
    if refused_a is None or "MixPlan" not in refused_a:
        raise AssertionError(f"streams control (a) (weights swapped): not refused: {refused_a}")
    say(f"control (a) weights of web and code swapped: refused ({refused_a[:110]}...)")

    # -- run B: resume from the RunManifest, restore, replay steps 7-14 ------------------
    params = init_params(param_specs(cfg), seed=SEED + 1, device="cuda")
    template = {"params": params, "opt": init_opt_state(params)}
    del params
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    resumed = TrainSession.resume(store, STREAMS_NS)
    state = resumed.restore_model(template)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    del template
    gc.collect()
    got = leaf_fingerprints(torch, state)
    moved = [p for (p, *a), (_, *b) in zip(got, bound) if a != b]
    if resumed.resume_step != STREAM_CKPT_STEP or moved:
        raise AssertionError(f"streams: resume_step {resumed.resume_step}, leaves moved {moved}")
    grids_b = []
    loop = new_loop(resumed, state["params"], state["opt"])
    with loop:
        rep_b = loop.run(STREAM_STEPS - STREAM_CKPT_STEP,
                         on_batch=lambda i, g: grids_b.append(g.copy()))
    code_seg = resumed.manifest_view("code").seg_seq
    resumed.close()
    del loop, state
    gc.collect()
    losses_b = rep_b.losses
    rel = [abs(b - a) / abs(a) for a, b in zip(losses_a[STREAM_CKPT_STEP:], losses_b)]
    same = [g.tobytes() for g in grids_b] == [g.tobytes() for g in grids_a[STREAM_CKPT_STEP:]]
    say(f"TrainSession.resume + restore_model {restore_s:.3f} s = "
        f"{state_bytes / restore_s / 1e9:.3f} GB/s; resume_step {resumed.resume_step}; leaves "
        f"bit-identical to the bound state: {len(got)} of {len(got)}; run B's "
        f"{len(grids_b)} steps consume run A's steps {STREAM_CKPT_STEP + 1}-{STREAM_STEPS} "
        f"byte for byte: {same} (the code readers start through compact segment {code_seg}); "
        f"losses {losses_b} against {losses_a[STREAM_CKPT_STEP:]}, largest relative difference "
        f"{max(rel):.3e} (limit {RESUME_LOSS_RTOL:g})")
    if not same or max(rel) > RESUME_LOSS_RTOL or code_seg < 0:
        raise AssertionError("streams: the resumed steps are not run A's steps 7-14")

    # -- negative control (b): the token with code's cursor one step back -------------------
    rows = tuple((n, v, s - 1 if n == "code" else s) for n, v, s in token.streams)
    control = TrainSession.resume(store, STREAMS_NS)
    reader = control.reader(dp_rank=0, cp_rank=0)
    try:
        reader.restore(dataclasses.replace(token, streams=rows))
        refused_b = None
    except ValueError as e:
        refused_b = str(e)
    # past the token's check: the code reader rewound one step under a reader
    # restored at the aligned token; the mix's schedule guard must refuse the
    # first code step
    v, s = token.stream_cursor("code")
    reader._subs["code"].consumer.restore_cursor(v, s - 1)
    guard, served = None, 0
    try:
        for _ in range(STREAM_STEPS - STREAM_CKPT_STEP):
            reader.next_batch(timeout_s=10.0)
            served += 1
    except RuntimeError as e:
        guard = str(e)
    control.close()
    if refused_b is None or "MixPlan" not in refused_b or guard is None:
        raise AssertionError(f"streams control (b) (code one step back): restore {refused_b}, "
                             f"guard {guard}")
    say(f"control (b) code's cursor one step back: the restore refuses it ({refused_b[:90]}...); "
        f"with the code reader rewound under a restored reader, the schedule guard refuses "
        f"the first code step after {served} other steps ({guard[:80]}...)")

    # -- fsck and inspect --------------------------------------------------------------
    report = fsck(run_ns)
    info = inspect_run(run_ns)
    issues = report.all_issues()
    dv = info["streams"]["filtered"].get("derive") or {}
    shard_rows = info["streams"]["code"]["manifests"]["sharded"]
    say(f"fsck: {report.summary()}; issues {[(i.severity, i.kind) for i in issues]}; filtered "
        f"derive cursors {dv.get('cursors')} (latest {dv.get('cursor')}); code shard bases "
        f"{[r['base_step'] for r in shard_rows['shards']]}, segments {shard_rows['segments']}")
    if any(i.severity == "error" for i in issues) or not dv.get("cursors") \
            or [r["base_step"] for r in shard_rows["shards"]] != list(seg.folds):
        raise AssertionError("streams: fsck reports an error, or sees no derive cursor, or the "
                             "code stream's shard bases disagree with the segment")

    # -- the operator CLI over this run's store: inspect, fsck, trim, fsck ------------------
    from repro_torch.ops.cli import _print_fsck

    cli_ms = {}
    rc_i, out, cli_ms["inspect --json"] = run_ops(store, STREAMS_NS, "--json", "inspect")
    inspect_same = json.loads(out) == json.loads(json.dumps(info))
    rc_f, out, cli_ms["fsck --json"] = run_ops(store, STREAMS_NS, "--json", "fsck")
    encoded = io.StringIO()
    _print_fsck(report, True, encoded)
    fsck_same = json.loads(out) == json.loads(encoded.getvalue())
    rc_t, out, cli_ms["trim --ranks 2 --json"] = run_ops(store, STREAMS_NS, "--json", "trim",
                                                         "--ranks", "2")
    trimmed = json.loads(out)
    rc_f2, out, cli_ms["fsck"] = run_ops(store, STREAMS_NS, "fsck")
    say(f"ops CLI over this run's store ({len(store.list(STREAMS_NS))} objects, "
        f"{store.total_bytes() / 1e9:.3f} GB): ms {({k: round(v, 3) for k, v in cli_ms.items()})}; "
        f"exit codes inspect {rc_i}, fsck {rc_f}, trim {rc_t}, fsck after trim {rc_f2}; "
        f"inspect --json equals inspect_run: {inspect_same}; fsck --json equals the encoding of "
        f"this phase's fsck report: {fsck_same}; trim rows "
        f"{[(r['stream'], r['advanced'], r['safe_step'], r['tgbs_deleted']) for r in trimmed]}; "
        f"fsck after trim: {out.splitlines()[0]}")
    if (rc_i, rc_f, rc_t, rc_f2) != (0, 0, 0, 0) or not inspect_same or not fsck_same \
            or len(trimmed) != 1 + len(STREAM_WEIGHTS):
        raise AssertionError(f"streams: the ops CLI over the run: exit codes "
                             f"{(rc_i, rc_f, rc_t, rc_f2)}, inspect equal {inspect_same}, fsck "
                             f"equal {fsck_same}, trim rows {len(trimmed)}")

    launches = dict(kcommon.launches)
    wrong = [i for i, n in enumerate(per_step) if n != want]
    say(f"launches over {len(per_step)} steps {launches}; a step {per_step[0]} (want {want}); "
        f"max_memory_allocated run A {peak_a:.2f} GiB, resume {torch.cuda.max_memory_allocated() / 2**30:.2f} "
        f"GiB; phase {time.monotonic() - t_phase:.1f} s")
    if wrong or len(per_step) != 2 * STREAM_STEPS - STREAM_CKPT_STEP:
        raise AssertionError(f"streams: steps {wrong} launched other than {want}")
    del store
    gc.collect()
    return launches


def phase_ops_chaos(smi):
    """Phase 13: the chaos harness and the operator CLI through their entry
    points, as subprocesses from the repository root: ``python -m
    repro_torch.chaos --json`` at each seed of CHAOS_SEEDS (the last with
    ``--trace``) and ``--list``; ``python -m repro_torch.ops`` over a
    ``FileObjectStore`` run with a planted orphan. Host code: no tensor, no
    kernel."""
    import tempfile
    import threading

    from repro_torch.core import (FileObjectStore, ManifestStore, Namespace, Producer,
                                  Watermark, write_watermark)

    def say(msg):
        log(f"ops/chaos: {msg}  [{smi}]")

    t_phase = time.monotonic()
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}

    def module(*args, **kw):
        return [sys.executable, "-m", *args], dict(cwd=ROOT, env=env, text=True, **kw)

    with tempfile.TemporaryDirectory() as tmp:
        trace = Path(tmp) / "chaos-trace.json"
        results, harness = {}, []

        def chaos(seed, *extra):
            argv, kw = module("repro_torch.chaos", "--json", "--seed", str(seed), *extra,
                              capture_output=True, timeout=HOST_TIMEOUT_S)
            t0 = time.monotonic()
            res = subprocess.run(argv, **kw)
            results[seed] = (res.returncode, json.loads(res.stdout) if res.stdout.strip() else [],
                             res.stderr, time.monotonic() - t0)

        try:
            # (a) the chaos harness, both seeds at once, beside (b)
            for seed in CHAOS_SEEDS:
                extra = ["--trace", str(trace)] if seed == CHAOS_SEEDS[-1] else []
                harness.append(threading.Thread(target=chaos, args=(seed, *extra)))
                harness[-1].start()

            # (b) the CLI over a FileObjectStore: tests/test_ops.py's file_run, a
            # watermark for trim, and a crashed incarnation's orphan TGB
            root = Path(tmp) / "store"
            ns = Namespace(FileObjectStore(str(root)), "runs/job")
            p = Producer(ns, "P", dp=1, cp=1, manifests=ManifestStore(ns))
            for _ in range(4):
                p.write_tgb(uniform_slice_bytes=64)
                p.maybe_commit(force=True)
            p.finalize()
            write_watermark(ns, 0, Watermark(version=3, step=2))
            orphan = ns.tgb_key("P", 1, "deadbeef")
            ns.store.put(orphan, b"junk")
            job = ["--root", str(root), "-n", "runs/job"]
            commands = [
                (job + ["--json", "fsck"], 1, lambda out: json.loads(out)["orphans"] == [orphan]),
                (job + ["fsck", "--repair"], 1, lambda out: f"[repaired] deleted {orphan}" in out),
                (job + ["fsck"], 0, lambda out: "clean" in out),
                (job + ["inspect"], 0, lambda out: "total_steps=4" in out),
                (job + ["trim", "--ranks", "1"], 0, lambda out: "safe_step=2" in out),
                (job + ["top"], 0, lambda out: "frontier v3 total_steps=4" in out),
                (["--root", str(Path(tmp) / "missing"), "-n", "runs/job", "fsck"], 2,
                 lambda out: True),
            ]
            cli = []
            for args, want_rc, check in commands:
                argv, kw = module("repro_torch.ops", *args, capture_output=True,
                                  timeout=HOST_TIMEOUT_S)
                t0 = time.perf_counter()
                res = subprocess.run(argv, **kw)
                ms = (time.perf_counter() - t0) * 1e3
                cli.append((" ".join(args).replace(tmp, "$TMP"), res.returncode, round(ms, 1)))
                if res.returncode != want_rc or not check(res.stdout):
                    raise AssertionError(f"ops/chaos (b): {args} exited {res.returncode} (want "
                                         f"{want_rc}): {res.stdout[-400:]} {res.stderr[-400:]}")
            say(f"(b) python -m repro_torch.ops over a FileObjectStore run with one orphan TGB: "
                f"(command, exit code, ms) {cli}; exit codes "
                f"{[c[1] for c in cli]}")
            argv, kw = module("repro_torch.chaos", "--list", capture_output=True,
                              timeout=HOST_TIMEOUT_S)
            listed = subprocess.run(argv, **kw)
            names = listed.stdout.split()
            if listed.returncode != 0 or names != sorted(CHAOS_SCENARIOS):
                raise AssertionError(f"ops/chaos (a): --list gave {listed.returncode} {names}")

        finally:
            for t in harness:   # each run ends by itself or at its timeout
                t.join()
        n_spans = len(json.loads(trace.read_text())["traceEvents"]) if trace.exists() else 0

    bad = [f"seed {seed}: no result" for seed in CHAOS_SEEDS if seed not in results]
    for seed, (rc, rows, err, wall) in sorted(results.items()):
        passed = [r for r in rows if r["passed"] and r["fsck_clean_after"]]
        counts = [(r["name"], r["steps_delivered"], r["orphans_detected"], r["faults_injected"],
                   round(r["recovery_latency_s"] * 1e3, 2)) for r in rows]
        say(f"(a) python -m repro_torch.chaos --json --seed {seed}: exit {rc}, "
            f"{len(passed)} of {len(CHAOS_SCENARIOS)} scenarios passed with fsck clean after, "
            f"{wall:.2f} s; (scenario, steps_delivered, orphans_detected, faults_injected, "
            f"recovery ms) {counts}")
        if rc != 0 or sorted(r["name"] for r in passed) != sorted(CHAOS_SCENARIOS):
            failed = [(r["name"], r["detail"]) for r in rows if r not in passed]
            bad.append(f"seed {seed}: exit {rc}, failed {failed} {err[-400:]}")
    say(f"(a) --list: {len(names)} scenarios; --trace wrote {n_spans} spans; phase "
        f"{time.monotonic() - t_phase:.1f} s")
    if bad or n_spans <= 0:
        raise AssertionError(f"ops/chaos (a): {bad}; trace spans {n_spans}")


def phase_examples(smi):
    """Phase 17: ``examples/{quickstart,failover,sft_mixture}_torch.py`` in
    process, each held to its own asserts and to its lines of
    EXAMPLE_STORIES. Host code: no tensor, no kernel."""
    import runpy

    t_phase = time.monotonic()
    for name, story in EXAMPLE_STORIES.items():
        out = io.StringIO()
        t0 = time.monotonic()
        with contextlib.redirect_stdout(out):
            runpy.run_path(str(ROOT / "examples" / f"{name}_torch.py"), run_name="__main__")
        wall = time.monotonic() - t0
        lines = out.getvalue().splitlines()
        missing = [want for want in story if not any(want in line for line in lines)]
        for line in lines:
            log(f"examples: {name}: {line}")
        log(f"examples: {name}_torch.py finished in {wall:.3f} s, {len(lines)} lines, "
            f"{len(story) - len(missing)} of {len(story)} story lines held")
        if missing:
            raise AssertionError(f"examples: {name}_torch.py did not tell {missing}")
    log(f"examples: phase 17 wall {time.monotonic() - t_phase:.3f} s  [{smi}]")


def phase_train_vs_plain(torch, label, cfg, control_name, control, prefix=0, layers=2):
    """A ``layers``-layer full-width cut: one train step's loss, gradients
    and grad norm, kernel path against plain path (the MoE family under the
    kernel path's routing, ``RoutingReplay``), and a negative control that
    must be refused."""
    from repro_torch.models import init_params, param_specs
    from repro_torch.models.common import tree_leaves
    from repro_torch.train import global_norm, loss_and_grads

    cfg = cfg.replace(num_layers=layers)
    label = f"{label} {layers}-layer train step"
    params = init_params(param_specs(cfg), seed=SEED + 2, device="cuda")
    batch = train_batch(torch, cfg, prefix, seed=SEED + 1)
    names = leaf_paths(params)

    def run():
        loss, _, grads = loss_and_grads(cfg, params, batch)
        return float(loss), tree_leaves(grads), float(global_norm(grads))

    with RoutingReplay(torch) as replay:
        kernel = run()
        with replay.replaying(), plain_path():
            p_loss, p_grads, p_norm = run()
        if replay.kept:
            log(f"{label}: the plain path replays the kernel path's "
                f"routing ({len(replay.kept)} calls: each layer's forward, then its "
                f"recompute in the backward); choices it would have made otherwise, per "
                f"call: {replay.flips} of {[int(k.numel()) for k in replay.kept]}")
        with replay.replaying(), control():
            control_run = run()

    def readings(tag, got):
        loss, grads, gnorm = got
        rows = []
        for name, g, w in zip(names, grads, p_grads):
            diff = (g.float() - w.float())
            rms_w = float(w.float().pow(2).mean().sqrt())
            rel = float(diff.pow(2).mean().sqrt()) / max(rms_w, 1e-30)
            rows.append((name, float(diff.abs().max()), float(w.float().abs().max()), rel))
        loss_rel = abs(loss - p_loss) / abs(p_loss)
        norm_rel = abs(gnorm - p_norm) / p_norm
        worst = max(r[3] for r in rows)
        log(f"{label}, {tag} vs plain: loss {loss:.6f} vs {p_loss:.6f} "
            f"(rel {loss_rel:.3e}, bound {TRAIN_LOSS_RTOL}); grad_norm {gnorm:.6f} vs "
            f"{p_norm:.6f} (rel {norm_rel:.3e}, bound {GRAD_NORM_RTOL}); worst leaf "
            f"RMS(diff)/RMS(plain) {worst:.4e} (bound {GRAD_RMS_TOL})")
        for name, err, top, rel in rows:
            log(f"    {name:24s} max|diff| {err:.3e} (max|plain| {top:.3e})  "
                f"RMS(diff)/RMS(plain) {rel:.4e}")
        return (loss_rel <= TRAIN_LOSS_RTOL and norm_rel <= GRAD_NORM_RTOL
                and worst <= GRAD_RMS_TOL)

    kernel_ok = readings("kernels", kernel)
    control_ok = readings(f"control ({control_name})", control_run)
    if not kernel_ok or control_ok:  # every reading is printed first
        raise AssertionError(f"{label}: kernels within bounds {kernel_ok}, "
                             f"control ({control_name}) within bounds {control_ok}")
    log(f"  control {label} ({control_name}): refused")


def control_k1_without_mask():
    """K1's backward rule recomputes attention without the causal mask."""
    from repro_torch.kernels.flash_attention import ops as fa_ops

    return swapped(fa_ops, "flash_attention_bwd",
                   lambda bwd: lambda q, k, v, causal, g: bwd(q, k, v, False, g))


def control_k4_time_reversed():
    """K4's backward rule runs on time-reversed inputs (and cotangent) and
    reverses its gradients back: the recurrence read backwards."""
    from repro_torch.kernels.wkv6 import ops as wkv_ops

    def wrap(bwd):
        def reversed_bwd(r, k, v, w, u, chunk, g):
            dr, dk, dv, dw, du = bwd(*(t.flip(1) for t in (r, k, v, w)), u, chunk, g.flip(1))
            return dr.flip(1), dk.flip(1), dv.flip(1), dw.flip(1), du
        return reversed_bwd

    return swapped(wkv_ops, "wkv6_bwd", wrap)


@contextlib.contextmanager
def control_heads_rolled(module="mamba2"):
    """The attention of ``repro_torch.models.<module>`` (the hybrid's shared
    block, or the transformer's layers) with each head's K1 and K3 output
    moved onto the next head (the kernels run as they are; their outputs
    are permuted)."""
    import importlib

    mod = importlib.import_module(f"repro_torch.models.{module}")
    with swapped(mod, "attention",
                 lambda fn: lambda *a, **kw: fn(*a, **kw).roll(1, dims=2)), \
            swapped(mod, "decode_attention",
                    lambda fn: lambda *a: fn(*a).roll(1, dims=1)):
        yield


def phase_hybrid(torch, kcommon, paths, skip_serving, free, done):
    """Phase 15: zamba2-7b served at full width and depth (a, unless
    ``skip_serving``), its 7-layer cut trained (b) and held kernels vs plain
    (c); adds the paths' launches to ``paths``."""
    from repro_torch.configs.registry import get_config

    cfg = get_config("zamba2_7b")
    cut = cfg.replace(num_layers=HYBRID_TRAIN_LAYERS)
    if not skip_serving:  # (a) full width and depth, and its profile
        params, paths["zamba2-7b"] = phase_serve_direct(torch, kcommon, cfg, hybrid_launches)
        phase_profile(torch, "zamba2-7b", cfg, params)
        del params
        free()
    # (b) the 7-layer cut's training
    paths["zamba2-7b train"], _ = phase_train(torch, kcommon, "zamba2-7b", cut)
    free()
    # (c) the same cut, kernels vs plain: serving, then one train step
    phase_kernel_vs_plain(torch, "zamba2-7b", cut, serving_weights(torch, cut),
                          layers=HYBRID_TRAIN_LAYERS,
                          control=("each head's K1 and K3 output moved onto the next head",
                                   control_heads_rolled))
    free()
    phase_train_vs_plain(torch, "zamba2-7b", cfg, "K1 backward without the causal mask",
                         control_k1_without_mask, layers=HYBRID_TRAIN_LAYERS)
    free()
    done(15)


def phase_audio(torch, kcommon, paths, skip_serving, free, done):
    """Phase 16: musicgen-medium served at full width and depth (a, unless
    ``skip_serving``), trained at full depth (b) and its 2-layer cut held
    kernels vs plain (c); qwen1.5-32b's 2-layer cut held kernels vs plain.
    Adds the paths' launches to ``paths``."""
    import functools

    from repro_torch.configs.registry import get_config

    cfg = get_config("musicgen_medium")
    rolled = ("each head's K1 and K3 output moved onto the next head",
              functools.partial(control_heads_rolled, "transformer"))
    if not skip_serving:  # (a) full width and depth, and its profile
        params, paths["musicgen-medium"] = phase_serve_direct(
            torch, kcommon, cfg, dense_launches, prefix=AUDIO_PREFIX)
        phase_profile(torch, "musicgen-medium", cfg, params, prefix=AUDIO_PREFIX)
        del params
        free()
    # (b) training at full depth, after the conditioning prefix
    paths["musicgen-medium train"], _ = phase_train(
        torch, kcommon, "musicgen-medium", cfg.replace(num_layers=AUDIO_TRAIN_LAYERS),
        prefix=AUDIO_PREFIX)
    free()
    # (c) the 2-layer cut, kernels vs plain: serving, then one train step
    cut = cfg.replace(num_layers=2)
    phase_kernel_vs_plain(torch, "musicgen-medium", cut, serving_weights(torch, cut),
                          control=rolled, prefix=AUDIO_PREFIX)
    free()
    phase_train_vs_plain(torch, "musicgen-medium", cfg, "K1 backward without the causal mask",
                         control_k1_without_mask, prefix=AUDIO_PREFIX)
    free()
    # qwen1.5-32b's 2-layer cut (its QKV bias on the path), kernels vs plain
    qwen = get_config("qwen15_32b").replace(num_layers=2)
    log(f"{qwen.name} 2-layer cut: d_model {qwen.d_model}, {qwen.num_heads} heads of "
        f"{qwen.head_dim} over {qwen.num_kv_heads}, QKV bias {qwen.qkv_bias}, "
        f"{qwen.param_count() / 1e9:.3f} B params")
    phase_kernel_vs_plain(torch, "qwen1.5-32b", qwen, serving_weights(torch, qwen),
                          control=rolled)
    free()
    done(16)


def main() -> int:
    global K1_OUTPUTS
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels", default=None,
                    help="comma-separated kernel names: build and check only "
                         "these (phases 1-3) and skip the serving phases")
    ap.add_argument("--skip-serving", action="store_true",
                    help="run phases 1-3, 6-13, 14 (b, c), 15 (b, c), 16 (b, c) "
                         "and 17 only")
    ap.add_argument("--only-moe", action="store_true",
                    help="run phases 1-3 and 14 only")
    ap.add_argument("--only-hybrid", action="store_true",
                    help="run phases 1-3 and 15 only")
    ap.add_argument("--only-audio", action="store_true",
                    help="run phases 1-3 and 16 only")
    ap.add_argument("--only-dryrun", action="store_true",
                    help="run phases 1-3 and 18 only")
    ap.add_argument("--only-large", action="store_true",
                    help="run phases 1-3 and 19 only")
    ap.add_argument("--tree", default=None,
                    help="import repro_torch from TREE/src, not this checkout's "
                         "(a parent's kernels timed by this harness)")
    ap.add_argument("--save", default=None,
                    help="write K1's outputs of phase 3 (torch.save) to this file")
    ap.add_argument("--compare", nargs="+", default=None,
                    help="files written by --save: are K1's outputs bit-identical?")
    args = ap.parse_args()
    # the phases an --only-* flag picks (none: every phase)
    chosen = {p for flag, p in (("moe", 14), ("hybrid", 15), ("audio", 16), ("dryrun", 18),
                                ("large", 19)) if getattr(args, f"only_{flag}")}

    def runs(phase):
        return not chosen or phase in chosen

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    if args.compare:
        return compare_saved(torch, args.compare)
    sys.path.insert(0, str((Path(args.tree).resolve() if args.tree else ROOT) / "src"))
    import gc

    import torch.nn.functional as F

    from repro_torch.kernels import common as kcommon

    names = kcommon.KERNELS if args.kernels is None else tuple(args.kernels.split(","))
    unknown = set(names) - set(kcommon.KERNELS)
    if unknown:
        raise SystemExit(f"chip_smoke: unknown kernels {sorted(unknown)}; "
                         f"choose from {kcommon.KERNELS}")

    t_mark = [time.monotonic()]

    def done(phase):
        """Log the wall time since the previous phase ended."""
        now = time.monotonic()
        log(f"phase {phase}: {now - t_mark[0]:.1f} s")
        t_mark[0] = now

    # -- 1. device ------------------------------------------------------------------
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = nvidia_smi_line()
    log(f"device: {name} (count {count}); torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(smi)  # as `nvidia-smi --query-gpu=name,power.limit` prints it
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 2. build -------------------------------------------------------------------
    t0 = time.monotonic()
    built = kcommon.build(names, force=True)
    log(f"build: {len(built)} kernels in {time.monotonic() - t0:.1f} s (parallel nvcc, sm_90a)")
    for kname, res in built.items():
        log(f"  {kname}: {res['seconds']:.1f} s")
        for line in res["log"].splitlines():
            if "Used" in line or "spill" in line or "Compiling entry" in line:
                log(f"    {line.strip()}")
    done("1-2")

    # -- 3. kernels vs plain ------------------------------------------------------------
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    if args.save:
        K1_OUTPUTS = {}  # filled by kernel_flash_attention
    entries = phase_kernels(torch, F, flush, names)
    del flush
    if args.save:
        Path(args.save).parent.mkdir(parents=True, exist_ok=True)
        torch.save(K1_OUTPUTS, args.save)
    done(3)
    if args.kernels is not None:  # phases 1-3 only: no main-path launches
        log(smi)
        log(json.dumps({"kernels": [entries[k] for k in names]}))
        return 0

    from repro_torch.configs.registry import get_config

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    paths = {}  # path -> its launches
    if not (args.skip_serving or chosen):
        # -- 4. granite-8b at full width, its profile and its 2-layer cut -----------------
        engine, paths["granite-8b"] = phase_serve(torch, kcommon, get_config("granite_8b"))
        phase_profile(torch, "granite-8b", engine.cfg, engine.params)
        phase_kernel_vs_plain(torch, "granite-8b", engine.cfg, engine.params)
        del engine
        free()
        done(4)

        # -- 5. rwkv6-3b at full width, its profile and its 2-layer cut -------------------
        cfg = get_config("rwkv6_3b")
        params, paths["rwkv6-3b"] = phase_serve_direct(torch, kcommon, cfg, rwkv_launches)
        phase_profile(torch, "rwkv6-3b", cfg, params)
        phase_kernel_vs_plain(torch, "rwkv6-3b", cfg, params)
        del cfg, params
        free()
        done(5)

    if not chosen:
        phases_6_to_13(torch, kcommon, paths, smi, free, done)
    # -- 14. the MoE family and the vision prefix -------------------------------------------
    if runs(14):
        phase_moe(torch, kcommon, paths, args.skip_serving, free, done)

    # -- 15. the Mamba2 / Zamba2 hybrid ------------------------------------------------------
    if runs(15):
        phase_hybrid(torch, kcommon, paths, args.skip_serving, free, done)

    # -- 16. the audio family, and qwen1.5-32b's QKV bias -----------------------------------
    if runs(16):
        phase_audio(torch, kcommon, paths, args.skip_serving, free, done)

    # -- 17. the data-plane examples (host code) ------------------------------------------
    if not chosen:
        kcommon.reset_launches()
        phase_examples(smi)
        paths["examples (host)"] = dict(kcommon.launches)
        done(17)

    # -- 18. the dry run and the card check of its counts ------------------------------------
    if runs(18):
        phase_dryrun(smi)
        phase_card_check(torch, kcommon, paths, smi, free)
        done(18)

    # -- 19. rep 16: the largest configs served as full-width cuts; the last four cut -------
    if runs(19):
        phase_large(torch, kcommon, paths, args.skip_serving, free, done, smi)

    # launches: each kernel's count on the path it was written for
    # (granite-8b's serving for K1-K3, rwkv6-3b's for K4, granite-8b's
    # training for K5; the training paths with --skip-serving, the chosen
    # phase's first path with an --only-* flag), and each path's count
    for kname, e in entries.items():
        path = {"wkv6": "rwkv6-3b", "adamw": "granite-8b train"}.get(kname, "granite-8b")
        e["launches_path"] = next(p for p in (path, f"{path} train", f"{path} card check",
                                              *paths) if p in paths)
        e["launches"] = paths[e["launches_path"]][kname]
        e["launches_by_path"] = {p: launches[kname] for p, launches in paths.items()}

    log(smi)
    log(json.dumps({"kernels": [entries[k] for k in kcommon.KERNELS]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0


def phase_moe(torch, kcommon, paths, skip_serving, free, done):
    """Phase 14: the MoE family and the vision prefix; adds the paths'
    launches to ``paths``."""
    from repro_torch.configs.registry import get_config

    if not skip_serving:  # (a) deepseek-moe-16b at full width and depth
        engine, paths["deepseek-moe-16b"] = phase_serve(torch, kcommon,
                                                        get_config("deepseek_moe_16b"))
        phase_drops(torch, engine.cfg, engine.params)
        phase_profile(torch, "deepseek-moe-16b", engine.cfg, engine.params)
        phase_kernel_vs_plain(torch, "deepseek-moe-16b", engine.cfg, engine.params)
        del engine
        free()
    # (b) qwen3-vl-30b-a3b, full width, 4 of 48 layers, on frame embeddings
    vl = get_config("qwen3_vl_30b_a3b")
    paths["qwen3-vl-30b-a3b train"], _ = phase_train(
        torch, kcommon, "qwen3-vl-30b-a3b", vl.replace(num_layers=VL_TRAIN_LAYERS),
        prefix=VL_PREFIX)
    free()
    # (c) its 2-layer cut's train step, kernels vs plain, with a control
    phase_train_vs_plain(torch, "qwen3-vl-30b-a3b", vl, "K1 backward without the causal mask",
                         control_k1_without_mask, prefix=VL_PREFIX)
    free()
    done(14)


def phase_large(torch, kcommon, paths, skip_serving, free, done, smi):
    """Phase 19: (a) llama3-405b and qwen3-moe-235b-a22b (rep 16) served as
    LARGE_SERVE_LAYERS-layer full-width cuts through ``ServeEngine`` (unless
    ``skip_serving``), with their profiles and, for the MoE, each layer's
    dropped share; (b) their 2-layer cuts, internvl2-76b's after
    VLM_PREFIX frame embeddings and deepseek-67b's, kernels vs plain with
    the heads control. Adds the serving paths' launches to ``paths``."""
    import functools

    from repro_torch.configs.registry import get_config

    rolled = ("each head's K1 and K3 output moved onto the next head",
              functools.partial(control_heads_rolled, "transformer"))
    for arch in ("llama3_405b", "qwen3_moe_235b_a22b"):
        cfg = get_config(arch)
        if skip_serving:
            cut = cfg.replace(num_layers=2)
            params = serving_weights(torch, cut)
        else:  # (a) the full-width cut through the engine, its profile
            cut = cfg.replace(num_layers=LARGE_SERVE_LAYERS)
            log(f"{cfg.name}: {cfg.num_heads} heads of {cfg.head_dim} over "
                f"{cfg.num_kv_heads} KV heads (rep {cfg.num_heads // cfg.num_kv_heads}), cut "
                f"to {LARGE_SERVE_LAYERS} of {cfg.num_layers} layers at full width  [{smi}]")
            engine, paths[cfg.name] = phase_serve(torch, kcommon, cut)
            params = engine.params
            del engine
            if cfg.family == "moe":
                phase_drops(torch, cut, params)
            phase_profile(torch, cfg.name, cut, params)
        # (b) its 2-layer cut, kernels vs plain
        phase_kernel_vs_plain(torch, cfg.name, cut, params, control=rolled)
        del params
        free()
    for arch, prefix in (("internvl2_76b", VLM_PREFIX), ("deepseek_67b", 0)):
        cut = get_config(arch).replace(num_layers=2)
        log(f"{cut.name} 2-layer cut: d_model {cut.d_model}, {cut.num_heads} heads of "
            f"{cut.head_dim} over {cut.num_kv_heads}, {cut.param_count() / 1e9:.3f} B params"
            + (f", after {prefix} frame embeddings" if prefix else ""))
        phase_kernel_vs_plain(torch, cut.name, cut, serving_weights(torch, cut),
                              control=rolled, prefix=prefix)
        free()
    done(19)


def phase_dryrun(smi):
    """Phase 18 (a): the dry run's named cells on both meshes, one
    subprocess a cell, all at once, then the roofline over their records."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    if DRYRUN_OUT.exists():
        for old in DRYRUN_OUT.glob("*.json"):
            old.unlink()
    DRYRUN_OUT.mkdir(parents=True, exist_ok=True)
    t0 = time.monotonic()
    procs = [(arch, shape, subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--mesh", "both", "--out", str(DRYRUN_OUT)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)) for arch, shape in DRYRUN_CELLS]
    failed = []
    for arch, shape, proc in procs:
        try:
            out, _ = proc.communicate(timeout=max(1.0, DRYRUN_TIMEOUT_S
                                                  - (time.monotonic() - t0)))
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
            failed.append(f"{arch} x {shape}: timed out")
        for line in out.splitlines():
            if line.startswith("[dryrun]"):
                log(f"  {line}")
        if proc.returncode != 0:
            failed.append(f"{arch} x {shape}: exit {proc.returncode}\n{out[-3000:]}")
    wall = time.monotonic() - t0
    records = [json.loads(p.read_text()) for p in sorted(DRYRUN_OUT.glob("*.json"))]
    bad = [r for r in records if r["status"] not in ("ok", "skipped")]
    if failed or bad or len(records) != 2 * len(DRYRUN_CELLS):
        raise AssertionError(f"dry run: {failed} {[(r['arch'], r['shape'], r['mesh'], r.get('error')) for r in bad]}")
    log(f"dry run: {len(records)} cells ({sum(r['status'] == 'ok' for r in records)} ok, "
        f"{sum(r['status'] == 'skipped' for r in records)} skipped) in {wall:.1f} s of wall, "
        f"{len(DRYRUN_CELLS)} subprocesses  [{smi}]")
    roof = subprocess.run([sys.executable, "-m", "repro_torch.launch.roofline", "--dir",
                           str(DRYRUN_OUT)], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=120)
    if roof.returncode != 0:
        raise AssertionError(f"roofline: exit {roof.returncode}\n{roof.stderr[-3000:]}")
    log("roofline (projections for a mesh of H100s from the dry run, not measurements):")
    for line in roof.stdout.splitlines():
        log(f"  {line}")


def dry_run_1x1(torch, cfg, shape, microbatches=None):
    """The dry run of ``cfg`` at ``shape`` (an ``InputShape``) on a 1x1 mesh
    of fake CUDA tensors: (costs, the 1x1 record's roofline row, its
    peak_per_device_bytes)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.kernels.common import register_shardings
    from repro_torch.launch import dryrun, roofline

    register_shardings()
    dryrun._init_fake_group(1)
    try:
        mesh = DeviceMesh("cuda", torch.arange(1).reshape(1, 1),
                          mesh_dim_names=("data", "model"))
        costs, meta, _n = dryrun.trace_costs(cfg, shape, mesh, device="cuda",
                                             microbatches=microbatches)
    finally:
        dist.destroy_process_group()
    rec = {"arch": cfg.name, "shape": shape.name, "mesh": "1x1", "status": "ok",
           "kind": shape.kind, "family": cfg.family, "seq_len": shape.seq_len,
           "global_batch": shape.global_batch, "params": cfg.param_count(),
           "active_params": cfg.active_param_count(), **dryrun.cost_record(costs, meta)}
    return costs, roofline.analyze_record(rec), rec["memory"]["peak_per_device_bytes"]


def phase_card_check(torch, kcommon, paths, smi, free):
    """Phase 18 (b): launches by kernel name from a profile of each path,
    and the dry run's FLOPs, memory and roofline step beside the card's."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs.registry import get_config
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch.hlo_analysis import analyze_profile
    from repro_torch.models import decode_step, init_decode_state, prefill
    from repro_torch.serve.engine import Request, ServeEngine

    def profiled(label, fn, want):
        """Run ``fn`` under torch.profiler: the wrappers' counts must equal
        ``want``, and so must the launches ``analyze_profile`` finds by
        kernel name, but for at most one in a thousand (at least one)
        missing. The tracer drops the first device events of each session,
        more the longer the process has run (4 at 55 s, 35 at 440 s on the
        H100), and never adds one; so TRACER_MARKERS spin kernels go first,
        and at least one of them must be seen: the drops ended before
        ``fn``'s first launch."""
        kcommon.reset_launches()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            open_trace(torch)
            fn()
            torch.cuda.synchronize()
        p = analyze_profile(prof)
        got = {k: p.launches(KERNEL_SYMBOLS[k]) for k in kcommon.LAUNCHES}
        markers = p.launches("spin_kernel")
        counts = dict(kcommon.launches)
        missed = {k: want[k] - got[k] for k in want}
        if counts != want or not markers or any(
                not 0 <= m <= max(1, want[k] // 1000) for k, m in missed.items()):
            raise AssertionError(f"{label}: launches {counts}, profiled {got}, want {want}; "
                                 f"{markers} of {TRACER_MARKERS} markers seen")
        log(f"card check {label}: launches {counts} = the table's; profiled by kernel name "
            f"{got} (missed {sum(missed.values())}; the tracer dropped "
            f"{TRACER_MARKERS - markers} of {TRACER_MARKERS} markers before them); device busy "
            f"{p.busy:.1%} of {p.wall_ms:.1f} ms, the markers included  [{smi}]")
        return counts

    def counted(fn):
        """(fn's output, its wall ms, its peak bytes) of a plain run, then
        the FLOPs FlopCounterMode counts over a second run."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        out = fn()
        torch.cuda.synchronize()
        ms = (time.monotonic() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated()
        with FlopCounterMode(display=False) as fc:
            fn()
        torch.cuda.synchronize()
        return out, ms, peak, fc.get_total_flops()

    def compare(label, real_flops, cfg, shape, ms, peak, microbatches=None):
        costs, row, dry_peak = dry_run_1x1(torch, cfg, shape, microbatches)
        if int(costs.flops) != int(real_flops):
            raise AssertionError(f"{label}: dry run {costs.flops:.6e} FLOPs, the card's "
                                 f"FlopCounterMode {real_flops:.6e}")
        log(f"card check {label}: FLOPs {real_flops:.6e} on the card = dry run (1x1); "
            f"dry-run peak_per_device_bytes {dry_peak / 2**30:.2f} GiB beside "
            f"max_memory_allocated {peak / 2**30:.2f} GiB; measured {ms:.3f} ms beside the "
            f"roofline step {row.step_time_s * 1e3:.3f} ms ({row.dominant}-bound; "
            f"compute {row.compute_s * 1e3:.3f}, memory {row.memory_s * 1e3:.3f} ms)  [{smi}]")

    # granite-8b's serving batch (phase 4's settings)
    cfg = get_config("granite_8b")
    engine = ServeEngine(cfg, serving_weights(torch, cfg), max_seq=MAX_SEQ, device="cuda")
    rng = np.random.default_rng(SEED)

    def requests(n_new):
        return [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, PROMPT, dtype=np.int32),
                        max_new_tokens=n_new) for i in range(BATCH)]

    engine.run_batch(requests(2))  # warm-up
    paths["granite-8b card check"] = profiled(
        "granite-8b serving batch", lambda: engine.run_batch(requests(NEW_TOKENS)),
        dense_launches(cfg, NEW_TOKENS - 1))
    tokens = token_grid(torch, cfg, np.random.default_rng(SEED), BATCH, PROMPT)
    with torch.inference_mode():
        state = init_decode_state(cfg, BATCH, MAX_SEQ, device="cuda")
        (logits, state), ms, peak, flops = counted(
            lambda: prefill(cfg, engine.params, {"tokens": tokens}, cache=state))
        compare("granite-8b prefill", flops, cfg, InputShape("card", PROMPT, BATCH, "prefill"),
                ms, peak)
        tok = torch.argmax(logits, dim=-1)
        _out, ms, peak, flops = counted(
            lambda: decode_step(cfg, engine.params, state, tok, PROMPT))
        compare("granite-8b decode step", flops, cfg,
                InputShape("card", MAX_SEQ, BATCH, "decode"), ms, peak)
    del engine, state, logits
    free()

    # the granite 8-layer train cut (phase 6's), one step
    from repro_torch.models import init_params, param_specs
    from repro_torch.train import OptimizerConfig, StepConfig, init_opt_state, make_train_step
    cut = cfg.replace(num_layers=GRANITE_TRAIN_LAYERS)
    params = init_params(param_specs(cut), seed=SEED, device="cuda")
    opt = init_opt_state(params)
    step = make_train_step(cut, OptimizerConfig(**TRAIN_OPT), StepConfig())
    batch = train_batch(torch, cut)
    step(params, opt, batch)  # warm-up
    paths["granite-8b train card check"] = profiled(
        f"granite-8b train step ({GRANITE_TRAIN_LAYERS} layers)",
        lambda: step(params, opt, batch),
        expected_train_launches(cut))
    _out, ms, peak, flops = counted(lambda: step(params, opt, batch))
    compare(f"granite-8b train step ({GRANITE_TRAIN_LAYERS} layers)", flops, cut,
            InputShape("card", TRAIN_SEQ, TRAIN_GB, "train"), ms, peak, microbatches=1)
    del params, opt, step, batch
    free()

    # rwkv6-3b's prefill
    cfg = get_config("rwkv6_3b")
    params = serving_weights(torch, cfg)
    tokens = token_grid(torch, cfg, np.random.default_rng(SEED), BATCH, PROMPT)
    with torch.inference_mode():
        state = init_decode_state(cfg, BATCH, MAX_SEQ, device="cuda")
        prefill(cfg, params, {"tokens": tokens}, cache=state)  # warm-up
        paths["rwkv6-3b card check"] = profiled(
            "rwkv6-3b prefill",
            lambda: prefill(cfg, params, {"tokens": tokens}, cache=state),
            rwkv_launches(cfg, 0))
        _out, ms, peak, flops = counted(
            lambda: prefill(cfg, params, {"tokens": tokens}, cache=state))
        compare("rwkv6-3b prefill", flops, cfg, InputShape("card", PROMPT, BATCH, "prefill"),
                ms, peak)
    del params, state
    free()


def phases_6_to_13(torch, kcommon, paths, smi, free, done):
    """The training phases on granite-8b and rwkv6-3b, the data-plane and
    recovery phases on the granite cut, and the host phase; each adds its
    launches to ``paths``."""
    from repro_torch.configs.registry import get_config

    # -- 6. granite-8b training, full width, 8 of 36 layers --------------------------------
    granite, rwkv = get_config("granite_8b"), get_config("rwkv6_3b")
    paths["granite-8b train"], granite_ms = phase_train(
        torch, kcommon, "granite-8b", granite.replace(num_layers=GRANITE_TRAIN_LAYERS))
    free()
    done(6)

    # -- 7. rwkv6-3b training, full width and depth ----------------------------------------
    paths["rwkv6-3b train"], _ = phase_train(
        torch, kcommon, "rwkv6-3b", rwkv.replace(num_layers=RWKV_TRAIN_LAYERS))
    free()
    done(7)

    # -- 8. one train step of each 2-layer cut, kernels vs plain, with a control ------------
    phase_train_vs_plain(torch, "granite-8b", granite, "K1 backward without the causal mask",
                         control_k1_without_mask)
    free()
    phase_train_vs_plain(torch, "rwkv6-3b", rwkv, "K4 backward on time-reversed inputs",
                         control_k4_time_reversed)
    free()
    done(8)

    # -- 9. fig17's three arms: the granite-8b cut of phase 6 off each data plane ----------
    cut = granite.replace(num_layers=GRANITE_TRAIN_LAYERS)
    paths["granite-8b fused"] = phase_fused(torch, kcommon, cut, granite_ms, smi)
    free()
    done(9)

    # -- 10. the same cut through a TrainSession: aligned checkpoint, kill, resume ---------
    paths["granite-8b resume"] = phase_resume(torch, kcommon, cut, smi)
    free()
    done(10)

    # -- 11. failure isolation and a brownout, with a live producer thread -----------------
    paths["granite-8b failure"] = phase_failure(torch, kcommon, cut, smi)
    free()
    done(11)

    # -- 12. a weighted mix of a raw, a sharded and a derived stream; checkpoint, resume ---
    paths["granite-8b streams"] = phase_streams(torch, kcommon, cut, smi)
    free()
    done(12)

    # -- 13. the chaos harness and the ops CLI's entry points (host code) ------------------
    kcommon.reset_launches()
    phase_ops_chaos(smi)
    paths["ops and chaos (host)"] = dict(kcommon.launches)
    done(13)


if __name__ == "__main__":
    sys.exit(main())
