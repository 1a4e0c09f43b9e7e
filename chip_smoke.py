#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            (from the repository root, one CUDA card)
    python3 chip_smoke.py --kernels rmsnorm,wkv6   (phases 1-3 for those only)
    python3 chip_smoke.py --skip-serving           (phases 1-3 and 6-12)

Phases, each of which raises (exit code != 0) on failure:

1. Device: the card's name, count, and ``nvidia-smi`` name / power limit.
2. Build: ``nvcc`` for sm_90a of every kernel under ``src/repro_torch/csrc``,
   one compiler per source, all started together; ptxas's register, shared
   memory and spill report per kernel.
3. Kernels against their plain PyTorch versions on the card, in bf16, at the
   serving paths' shapes (RMSNorm at both models' widths, 4096 and 2560)
   plus a ragged and a tiny case each: max |err| and
   the worst element's share of its limit (one bf16 ulp of the value plus
   1-2% of its output vector's RMS; see KERNEL_RTOL), with a one-key fault that the
   check must refuse for each attention kernel and two for WKV6 (u zeroed:
   y refused; the last token's k zeroed: the state refused); the kernel's and the plain
   version's time (CUDA events, per launch after warm-up, L2 flushed before
   each launch), one PyTorch library call of the same function as a
   yardstick (never used by the port; WKV6 has none), and the least time the card could
   take (bytes over 3.35 TB/s, operations over the peak rate for their
   type).
4. Serving at full width: granite-8b (36 layers, d_model 4096) with random
   weights from a seeded torch generator, cast once to bf16, serves 8
   requests of 1000-token prompts, 32 new tokens each, through
   ``ServeEngine.run_batch``. Launch counts are reset just before and read
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
   memory, launches (33 / 16 / 0 a step) and the phase's seconds.

11. Failure isolation and a brownout on the cut of phase 9 (depth 2, 12
   steps a run, one state): (a) the colocated pool dies after step 3
   (``inject_crash``) and the loop must raise ``BatchTimeout`` within its
   5 s timeout, which the isolation check (every step run, every grid the
   packer's, once) refuses: the negative control; (b) a live tgb producer
   thread (``run_producer_loop``, 0.2 s a TGB) dies before its 5th TGB
   without finalizing, a replacement writer recovers on enter from the
   manifest 1 s later and continues, and the trainer must pass the same
   check, with the data_wait of the steps around the kill printed; (c) the
   tgb arm through ``FaultyObjectStore(MemoryObjectStore(LatencyModel()),
   FaultPolicy(slow_get_rate=0.15, slow_get_s=0.06))`` with fig16's storm
   (``BrownoutPhase(target_rate=120, retry_after_s=0.1)``) over the middle
   third of the run, ``resilience=`` fig16's client, a live producer with
   ``spill_limit=256`` and flight-recorder snapshots: grids and losses
   bit-identical to a fault-free run from the same state, throttles seen >
   0, the data_wait share of each third, and the producer's latest
   snapshot under ``<ns>/obs/`` equal to the live registry.

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
   bases at the segment's folds. Printed, each beside the card's name and
   power limit: tokens/s at the median step, the split, the derive worker's
   TGBs, uploads and hits before and after the kill, the compactor's cycle,
   the checkpoint's upload and commit, resume + restore, peak memory,
   launches (33 / 16 a step) and the phase's seconds.

The last lines are the ``nvidia-smi`` name/power-limit line as it prints
it, one JSON object with every kernel's numbers, and ``{"ok": true,
"device": {...}}``. A kernel's ``launches`` is its count on the serving path
it was ported for (granite-8b for RMSNorm and both attention kernels,
rwkv6-3b for WKV6); ``launches_by_path`` gives each path's count, the
training paths' over their 3 steps, the fused path's over its 53, the
resume path's over its 11, the failure path's over its steps, the streams
path's over its 22.
"""
from __future__ import annotations

import contextlib
import json
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
# Phase 8's bounds, kernel path against plain path. The backward rules are
# the same plain functions on both paths, so the gradients differ only
# through the forward kernels' outputs; the forward 2-layer cuts read
# RMS(diff) / RMS(plain) 0.005-0.009, so 5e-2 leaves about 5x.
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
# the forward kernels' names as the profiler lists them
KERNEL_SYMBOLS = {"rmsnorm": "rmsnorm_kernel", "flash_attention": "fa_fwd_kernel",
                  "decode_attention": "decode_kernel", "wkv6": "wkv6_kernel"}


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(torch, fn, flush, iters: int, warmup: int = 3) -> float:
    """Median per-launch device time of ``fn`` over ``iters`` launches, each
    preceded (outside the timed window) by a write that evicts the L2."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        flush.zero_()
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
    """K2 RMSNorm: granite-8b's D 4096, rwkv6-3b's D 2560, at the serving
    and the training rows. Timed through the launcher ``rmsnorm_fwd``."""
    from repro_torch.kernels.rmsnorm.ops import rmsnorm, rmsnorm_fwd
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

    train_rows = TRAIN_GB * TRAIN_SEQ
    for label, rows, dim in (("prefill", BATCH * PROMPT, 4096), ("decode", BATCH, 4096),
                             ("ragged", 1001, 4096), ("rwkv prefill", BATCH * PROMPT, 2560),
                             ("rwkv decode", BATCH, 2560), ("tiny", 3, 64),
                             ("train", train_rows, 4096), ("rwkv train", train_rows, 2560)):
        x, w = randn(rows, dim), randn(dim, dtype=torch.float32)
        err, share = check_kernel(torch, f"rmsnorm {label}", rmsnorm(x, w),
                                  rmsnorm_ref(x, w))
        line = f"rmsnorm {label} ({rows}, {dim}): max|err| {err:.3e} ({share:.2f} of limit)"
        if label in ("prefill", "decode", "rwkv prefill"):
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
                if label == "rwkv prefill":
                    entries["rmsnorm"].update({key + "_library_ms": lib,
                                               key + "_bound_ms": b_ms})
        log(line)


def kernel_flash_attention(torch, F, flush, randn, entries):
    """K1 flash attention at granite-8b's prefill and training shapes.
    Timed through the launcher ``flash_attention_fwd``."""
    from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                         flash_attention_fwd)
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    for label, (B, S, H, G, dh, causal) in (
            ("prefill", (BATCH, PROMPT, 32, 8, 128, True)),
            ("train", (TRAIN_GB, TRAIN_SEQ, 32, 8, 128, True)),
            ("ragged", (2, 45, 4, 2, 128, True)),
            ("full", (2, 100, 6, 3, 64, False)),
            ("tiny", (1, 5, 2, 1, 64, True))):
        q, k, v = randn(B, S, H, dh), randn(B, S, G, dh), randn(B, S, G, dh)
        err, share = check_kernel(torch, f"flash_attention {label}",
                                  flash_attention(q, k, v, causal),
                                  flash_attention_ref(q, k, v, causal))
        line = (f"flash_attention {label} q{(B, S, H, dh)} kv{(B, S, G, dh)}: "
                f"max|err| {err:.3e} ({share:.2f} of limit)")
        if label == "prefill":
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
            entries["flash_attention"] = dict(
                name="flash_attention", route="cuda",
                source="src/repro_torch/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention/kernel.py:29",
                shape=f"q ({B}, {S}, {H}, {dh}) kv ({B}, {S}, {G}, {dh}) bf16 causal",
                max_abs_err=err, max_err_share_of_limit=share, ms=ms,
                plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib)
        log(line)
        if label == "prefill":  # one key's value lost: only the last row sees it
            v_bad = v.clone()
            v_bad[:, -1] = 0
            check_rejects(torch, "flash_attention prefill, last key's value zeroed",
                          flash_attention(q, k, v_bad, causal),
                          flash_attention_ref(q, k, v, causal))


def kernel_decode_attention(torch, F, flush, randn, entries):
    """K3 flash decode at granite-8b's decode shape."""
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref

    cur_main = PROMPT + NEW_TOKENS // 2 - 1
    for label, (B, H, G, dh, T, cur) in (
            ("decode", (BATCH, 32, 8, 128, MAX_SEQ, cur_main)),
            ("tail", (BATCH, 32, 8, 128, MAX_SEQ, MAX_SEQ - 1)),
            ("ragged", (3, 6, 3, 64, 100, 70)),
            ("tiny", (1, 8, 1, 64, 5, 0))):
        q, kc, vc = randn(B, H, dh), randn(B, T, G, dh), randn(B, T, G, dh)
        err, share = check_kernel(torch, f"decode_attention {label}",
                                  decode_attention(q, kc, vc, cur),
                                  decode_attention_ref(q, kc, vc, cur))
        line = (f"decode_attention {label} q{(B, H, dh)} cache{(B, T, G, dh)} cur {cur}: "
                f"max|err| {err:.3e} ({share:.2f} of limit)")
        if label == "decode":
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
            entries["decode_attention"] = dict(
                name="decode_attention", route="cuda",
                source="src/repro_torch/csrc/decode_attention.cu",
                replaces="src/repro/kernels/decode_attention/kernel.py:34",
                shape=f"q ({B}, {H}, {dh}) cache ({B}, {T}, {G}, {dh}) bf16 cur_index {cur}",
                max_abs_err=err, max_err_share_of_limit=share, ms=ms,
                plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib)
        log(line)
        if label == "decode":  # the newest key left out of the kernel's range
            check_rejects(torch, "decode_attention decode, newest key dropped",
                          decode_attention(q, kc, vc, cur - 1),
                          decode_attention_ref(q, kc, vc, cur))


def kernel_wkv6(torch, F, flush, randn, entries):
    """K4 WKV6 at rwkv6-3b's prefill and training shapes. Timed through the
    launcher ``wkv6_fwd``."""
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


KERNEL_PHASES = {"rmsnorm": kernel_rmsnorm, "flash_attention": kernel_flash_attention,
          "decode_attention": kernel_decode_attention, "wkv6": kernel_wkv6}


def phase_serve(torch, kcommon):
    """Full-width granite-8b serving; returns (engine, launches)."""
    import numpy as np

    from repro_torch.configs.registry import get_config
    from repro_torch.models import init_params, param_specs
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = get_config("granite_8b")
    t0 = time.monotonic()
    params = init_params(param_specs(cfg), seed=SEED, device="cuda")
    engine = ServeEngine(cfg, params, max_seq=MAX_SEQ, device="cuda")
    del params  # the engine holds the bf16 copies of the matrices
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"granite-8b: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.param_count() / 1e9:.3f} B params; init + cast {time.monotonic() - t0:.1f} s")

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
    want = {"rmsnorm": (2 * cfg.num_layers + 1) * (1 + steps),
            "flash_attention": cfg.num_layers,
            "decode_attention": cfg.num_layers * steps, "wkv6": 0}
    if steps != NEW_TOKENS - 1 or launches != want:
        raise AssertionError(f"launch counts {launches} (decode steps {steps}), want {want}")
    log(f"serve: batch {BATCH} x prompt {PROMPT}, {NEW_TOKENS} new tokens each: "
        f"prefill {prefill_s * 1e3:.2f} ms; decode {steps} steps in {decode_s * 1e3:.2f} ms "
        f"({decode_s / steps * 1e3:.3f} ms/step, {tokens / decode_s:.1f} tokens/s "
        f"as tokens_out / wall_decode_s); max_memory_allocated {peak / 2**30:.2f} GiB")
    log(f"serve launches: {launches} (expected {want})")
    log(f"serve sample: request 0 generated {reqs[0].generated[:8]} ...")
    return engine, launches


def phase_serve_rwkv(torch, kcommon):
    """Full-width rwkv6-3b serving through the model-level API; returns
    (cfg, params, launches)."""
    import numpy as np

    from repro_torch.configs.registry import get_config
    from repro_torch.models import (decode_step, init_decode_state, init_params,
                                    param_specs, prefill)
    from repro_torch.serve.engine import serving_params

    cfg = get_config("rwkv6_3b")
    t0 = time.monotonic()
    with torch.inference_mode():
        params = serving_params(cfg, init_params(param_specs(cfg), seed=SEED, device="cuda"),
                                torch.device("cuda"))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"rwkv6-3b: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.d_model // cfg.rwkv_head_dim} WKV heads of {cfg.rwkv_head_dim}, "
        f"{cfg.param_count() / 1e9:.3f} B params; init + cast {time.monotonic() - t0:.1f} s")
    rng = np.random.default_rng(SEED)

    @torch.inference_mode()
    def serve(n_new):
        """Prefill, then greedy decode as ServeEngine.run_batch does it (the
        host reads each token). Returns (tokens, prefill s, decode s,
        launches counted by the end of prefill, last logits)."""
        prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (BATCH, PROMPT))).cuda()
        t0 = time.monotonic()
        state = init_decode_state(cfg, BATCH, MAX_SEQ, device="cuda")
        logits, state = prefill(cfg, params, {"tokens": prompts}, cache=state)
        torch.cuda.synchronize()
        prefill_s = time.monotonic() - t0
        at_prefill = dict(kcommon.launches)
        tok, out = torch.argmax(logits, dim=-1), []
        t0 = time.monotonic()
        for i in range(n_new):
            out.append(tok.cpu())
            if i + 1 == n_new:
                break
            logits, state = decode_step(cfg, params, state, tok, PROMPT + i)
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
    per_norm = 3 * cfg.num_layers + 1
    want_prefill = {"rmsnorm": per_norm, "flash_attention": 0, "decode_attention": 0,
                    "wkv6": cfg.num_layers}
    want = dict(want_prefill, rmsnorm=per_norm * (1 + steps))
    if at_prefill != want_prefill or launches != want:
        raise AssertionError(f"rwkv6-3b launch counts {at_prefill} after prefill, {launches} "
                             f"after {steps} decode steps; want {want_prefill}, {want}")
    if tuple(tokens.shape) != (BATCH, NEW_TOKENS) or not bool(
            ((tokens >= 0) & (tokens < cfg.vocab_size)).all()):
        raise AssertionError(f"rwkv6-3b: bad tokens {tokens}")
    if not bool(torch.isfinite(logits.float()).all()):
        raise AssertionError("rwkv6-3b: non-finite logits")
    log(f"rwkv serve: batch {BATCH} x prompt {PROMPT}, {NEW_TOKENS} new tokens each: "
        f"prefill {prefill_s * 1e3:.2f} ms; decode {steps} steps in {decode_s * 1e3:.2f} ms "
        f"({decode_s / steps * 1e3:.3f} ms/step, {tokens.numel() / decode_s:.1f} tokens/s "
        f"as tokens out / decode wall); max_memory_allocated {peak / 2**30:.2f} GiB")
    log(f"rwkv serve launches: {at_prefill} after prefill, {launches} in all "
        f"(expected {want_prefill}, {want})")
    log(f"rwkv serve sample: sequence 0 generated {tokens[0, :8].tolist()} ...")
    return cfg, params, launches


def phase_profile(torch, name, cfg, params):
    """Where serving time goes: device-busy share of one prefill and of 8
    decode steps (torch.profiler, CUDA activity only), and the kernels that
    take the most device time."""
    from repro_torch.models import decode_step, init_decode_state, prefill

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen, device="cuda")
    with torch.inference_mode():
        state = init_decode_state(cfg, BATCH, MAX_SEQ, device="cuda")

        def run_prefill():
            prefill(cfg, params, {"tokens": tokens}, cache=state)

        def run_decode():  # as ServeEngine.run_batch: the host reads each token
            tok = tokens[:, -1]
            for i in range(8):
                logits, _ = decode_step(cfg, params, state, tok, PROMPT + i)
                tok = torch.argmax(logits, dim=-1)
                tok.cpu()

        for label, fn in (("prefill", run_prefill), ("8 decode steps", run_decode)):
            device_profile(torch, f"{name} {label}", fn)


def device_profile(torch, label, fn):
    """Run ``fn`` once under torch.profiler (CUDA activity only); log the
    wall, the device-busy share and the 8 largest device lines. Returns
    (rows as (device us, key), busy s)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        fn()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    rows = sorted(((e.self_device_time_total, e.key) for e in prof.key_averages()
                   if e.self_device_time_total > 0), reverse=True)
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
    from repro_torch.models import rwkv6, transformer

    plain = {
        (transformer, "rms_norm"): rmsnorm_ref,
        (transformer, "attention"): flash_attention_ref,
        (transformer, "decode_attention"): decode_attention_ref,
        (rwkv6, "rms_norm"): rmsnorm_ref,
        (rwkv6, "wkv6"): wkv6_chunked,
    }
    saved = {key: getattr(*key) for key in plain}
    for (mod, name), fn in plain.items():
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)


def phase_kernel_vs_plain(torch, name, cfg, params):
    """2-layer cut at full width: kernel path vs plain path on the card."""
    import numpy as np

    from repro_torch.models import decode_step, init_decode_state, prefill

    cfg = cfg.replace(num_layers=2)
    params = dict(params, layers={k: v[:2] for k, v in params["layers"].items()})
    rng = np.random.default_rng(SEED + 1)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (BATCH, PROMPT))).cuda()

    def run():
        state = init_decode_state(cfg, BATCH, MAX_SEQ, device="cuda")
        logits, state = prefill(cfg, params, {"tokens": tokens}, cache=state)
        outs = [logits]
        for i, tok in enumerate(feed):
            logits, state = decode_step(cfg, params, state, tok, PROMPT + i)
            outs.append(logits)
        return outs

    with torch.inference_mode():
        feed = []
        kernel = run()  # pass 1 only fixes the fed tokens
        feed = [torch.argmax(kernel[0], -1)]
        for _ in range(2):
            feed.append((feed[-1] * 7 + 1) % cfg.vocab_size)
        kernel = run()
        with plain_path():
            plain = run()
    steps = ["prefill logits"] + [f"decode step {i} logits" for i in range(1, len(kernel))]
    rows = [read_close(torch, f"{name} 2-layer {step}", a, b)
            for step, a, b in zip(steps, kernel, plain)]
    rms = [float(b.float().pow(2).mean().sqrt()) for b in plain]
    log(f"{name} 2-layer cut, kernels vs plain on the card (bf16, atol = rtol = {E2E_TOL}; "
        f"prefill, then decode steps 1-{len(rows) - 1}): max|err| "
        f"{[f'{r[0]:.3e}' for r in rows]}; worst element's share of atol + rtol |plain| "
        f"{[f'{r[1]:.3f}' for r in rows]}; RMS(diff) / RMS(plain) "
        f"{[f'{r[2]:.4f}' for r in rows]}; RMS of the plain logits "
        f"{[f'{r:.3f}' for r in rms]}")
    failed = [step for step, r in zip(steps, rows) if not r[3]]
    if failed:  # every reading is printed first
        raise AssertionError(f"{name} 2-layer cut: {failed} over the allclose limit "
                             f"atol = rtol = {E2E_TOL}")


def leaf_paths(tree, prefix=""):
    """Dotted paths of a parameter tree's leaves, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in leaf_paths(tree[k], f"{prefix}{k}.")]
    return [prefix[:-1]]


def expected_train_launches(cfg):
    """Kernel launches of one train step with remat: each forward kernel in
    the forward and again in its layer's recompute; the final norm, outside
    the layers, once."""
    per_layer = ({"rmsnorm": 3, "wkv6": 1} if cfg.family == "rwkv"
                 else {"rmsnorm": 2, "flash_attention": 1})
    want = {"rmsnorm": 1, "flash_attention": 0, "decode_attention": 0, "wkv6": 0}
    for name, n in per_layer.items():
        want[name] += 2 * n * cfg.num_layers
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


def phase_train(torch, kcommon, label, cfg):
    """Full-width training: TRAIN_STEPS AdamW steps on one batch, then one
    profiled step. Returns the launches of the TRAIN_STEPS steps and each
    step's wall ms."""
    import numpy as np

    from repro_torch.models import init_params, param_specs
    from repro_torch.models.common import tree_leaves
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
    rng = np.random.default_rng(SEED)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (TRAIN_GB, TRAIN_SEQ))).cuda()}
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
        log(f"{label} train step {i + 1}: loss {m['loss']:.6f}  grad_norm {m['grad_norm']:.6f}"
            f"  lr {m['lr']:.3e}  {wall * 1e3:.2f} ms  {tokens / wall:.1f} tokens/s  "
            f"launches {per_step}")
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
                  for k, sym in KERNEL_SYMBOLS.items() if want[k]})
    log(f"{label} train step, device time by part (CUDA events around each backward rule "
        f"and AdamW; the profiler's kernel lines for the forward kernels): step {step_ms:.2f} ms; "
        + "; ".join(f"{k} {v:.2f} ms = {v / step_ms:.1%}" for k, v in parts.items()))

    bad = [i + 1 for i, (m, per_step, _) in enumerate(readings)
           if per_step != want or not all(np.isfinite([m["loss"], m["grad_norm"]]))]
    if bad or moved != len(samples):
        raise AssertionError(f"{label} train: steps {bad} have non-finite loss or grad norm "
                             f"or launches other than {want}; {moved} of {len(samples)} "
                             f"leaves moved")
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
    session = open_dataplane(MemoryObjectStore(latency=LatencyModel()), topo,
                             namespace="runs/kill")
    events = {}

    class Killed(Exception):
        pass

    def first_payload(offset):
        if offset == KILL_AFTER_TGBS:
            raise Killed()
        return slices[offset]

    def producers():
        w1 = session.writer("w0").__enter__()
        try:
            run_producer_loop(w1.producer, FUSED_BATCHES, 0, produce_delay_s=PRODUCE_DELAY_S,
                              payload_fn=first_payload)
        except Killed:   # the thread dies; its writer is never finalized
            events["kill"] = time.monotonic()
            events["pending"] = len(w1.producer.pending)
        time.sleep(RESTART_S)
        w2 = session.writer("w0").__enter__()   # recover() from the manifest
        events["recovered"] = (time.monotonic(), w2.recovered_offset)
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
        f"{live.get(scope + '.commit_successes')}); case {case_s():.1f} s")
    session.close()
    if not same or rs.throttled <= 0 or thread.is_alive() or snap is None \
            or snap["metrics"] != live:
        raise AssertionError(f"failure (c): bit-identical {same}, throttles seen "
                             f"{rs.throttled}, snapshot equals the registry "
                             f"{snap is not None and snap['metrics'] == live}")

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


def phase_train_vs_plain(torch, label, cfg, control_name, control):
    """A 2-layer full-width cut: one train step's loss, gradients and grad
    norm, kernel path against plain path, and a negative control that must
    be refused."""
    import numpy as np

    from repro_torch.models import init_params, param_specs
    from repro_torch.models.common import tree_leaves
    from repro_torch.train import global_norm, loss_and_grads

    cfg = cfg.replace(num_layers=2)
    params = init_params(param_specs(cfg), seed=SEED + 2, device="cuda")
    rng = np.random.default_rng(SEED + 1)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (TRAIN_GB, TRAIN_SEQ))).cuda()}
    names = leaf_paths(params)

    def run():
        loss, _, grads = loss_and_grads(cfg, params, batch)
        return float(loss), tree_leaves(grads), float(global_norm(grads))

    with plain_path():
        p_loss, p_grads, p_norm = run()

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
        log(f"{label} 2-layer train step, {tag} vs plain: loss {loss:.6f} vs {p_loss:.6f} "
            f"(rel {loss_rel:.3e}, bound {TRAIN_LOSS_RTOL}); grad_norm {gnorm:.6f} vs "
            f"{p_norm:.6f} (rel {norm_rel:.3e}, bound {GRAD_NORM_RTOL}); worst leaf "
            f"RMS(diff)/RMS(plain) {worst:.4e} (bound {GRAD_RMS_TOL})")
        for name, err, top, rel in rows:
            log(f"    {name:24s} max|diff| {err:.3e} (max|plain| {top:.3e})  "
                f"RMS(diff)/RMS(plain) {rel:.4e}")
        return (loss_rel <= TRAIN_LOSS_RTOL and norm_rel <= GRAD_NORM_RTOL
                and worst <= GRAD_RMS_TOL)

    kernel_ok = readings("kernels", run())
    with control():
        control_ok = readings(f"control ({control_name})", run())
    if not kernel_ok or control_ok:  # every reading is printed first
        raise AssertionError(f"{label} 2-layer train step: kernels within bounds {kernel_ok}, "
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


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels", default=None,
                    help="comma-separated kernel names: build and check only "
                         "these (phases 1-3) and skip the serving phases")
    ap.add_argument("--skip-serving", action="store_true",
                    help="run phases 1-3 and the training phases 6-12 only")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
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
    entries = phase_kernels(torch, F, flush, names)
    del flush
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
    if not args.skip_serving:
        # -- 4. granite-8b at full width, its profile and its 2-layer cut -----------------
        engine, paths["granite-8b"] = phase_serve(torch, kcommon)
        phase_profile(torch, "granite-8b", engine.cfg, engine.params)
        phase_kernel_vs_plain(torch, "granite-8b", engine.cfg, engine.params)
        del engine
        free()
        done(4)

        # -- 5. rwkv6-3b at full width, its profile and its 2-layer cut -------------------
        cfg, params, paths["rwkv6-3b"] = phase_serve_rwkv(torch, kcommon)
        phase_profile(torch, "rwkv6-3b", cfg, params)
        phase_kernel_vs_plain(torch, "rwkv6-3b", cfg, params)
        del cfg, params
        free()
        done(5)

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

    # launches: each kernel's count on the serving path it was ported for
    # (granite-8b for K1-K3, rwkv6-3b for K4; their training paths with
    # --skip-serving), and each path's count beside it
    for kname, e in entries.items():
        path = "rwkv6-3b" if kname == "wkv6" else "granite-8b"
        e["launches_path"] = path if path in paths else f"{path} train"
        e["launches"] = paths[e["launches_path"]][kname]
        e["launches_by_path"] = {p: launches[kname] for p, launches in paths.items()}

    log(smi)
    log(json.dumps({"kernels": [entries[k] for k in kcommon.KERNELS]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
