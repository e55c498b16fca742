#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases, in order; each one asserts, so any failure ends the script with a
traceback and a non-zero exit (phase 15 gathers its cut checks' failures
and raises on them all at its end):

  1. device  — the card's name and power limit (nvidia-smi) and
               torch.cuda.get_device_name().
  2. build   — compile the four kernel sources under kernels/csrc/
               (segment_reduce.cu, flash_attention.cu,
               flash_attention_bwd.cu, decode_attention.cu) with nvcc for
               sm_90a, one nvcc each, all started together
               (each ptxas register / shared-memory report is printed; a
               ptxas remark that it serialized the wgmmas, or a spill in
               any decode instantiation or any kernel of the flash
               backward, bf16 or fp32, fails the run).
  3. kernels — the hand kernel against its plain PyTorch version on the
               card, sum and max, fp32 and bf16: the shapes of
               tests/test_kernels.py and the edge cases (an unreached row,
               the -inf pad row, dropped edges). Per shape: two launches
               bitwise equal; the output bit for bit against its exact
               oracle (the sum: a layout-order np.add.at fold in fp32 in
               the segments of the kernel's launch plan, bf16 rounded
               once; max: scatter_reduce_ amax), shown once to reject an
               output with one row zeroed; max error against the plain
               version; kernel / plain / library / bound ms.
  4. serve   — the port's `gnn_serve` entry point at full width (GAT, then
               SAGE: --features 512 --hidden 512 --layers 3 --classes 16,
               4 heads) on OR scale 1.0, hep100, k=4, tiled (the kernel),
               with the launch counters set to 0 before and read after each
               run; then the same runs with --agg-backend scatter, held at
               rtol=atol=2e-4; and a small run on the card held against the
               same run on the CPU. p50/p99 latencies are modeled on the
               paper's cluster by `serve_request`; host compute and layer
               times are measured on the card. Then phase 8's first batch
               is drawn on the host (a CPU trainer at its configuration),
               and each layer's tiled layout is kept for phase 5 at every
               (combiner, rows, F) a GAT or SAGE mini-batch step launches;
               and phase 7's ring book is built on the host, its first
               stage's layout kept at every (combiner, rows, F) a GAT or
               SAGE tiled ring step launches (rows 25,600 = 4 x 6,400);
               and phase 12's grid partitions (STUDY_GRID_METHODS) are
               made on the host into its partition cache, the first
               one's layer-wise layout kept at every (combiner, rows, F)
               a GAT tiled pass launches (`study_shapes`).
  5. shapes  — every (combiner, rows, F) the kernel ran at in phase 4, or
               that phase 7's ring, phase 8, phase 10's elastic run or
               phase 12's serving grid will launch, again on the
               `local_dst` that phase 4 passed it (kept from its first
               launch), that the ring's first stage or phase 8's first
               batch holds, with random messages: the
               checks of
               phase 3 (at rows=69632, F=512 the sum's fold covers the
               first columns that fit FOLD_MAX_TERMS terms), and kernel /
               plain / library / bound ms.
  6. attention — the flash and decode kernels against their plain versions
               at the shapes of tests/test_kernels.py, at ragged shapes, at
               flash shapes that straddle its tiles (STRADDLE), at the
               decode edge cases (valid_len 0, 1, S, S + 5) and at decode
               shapes whose valid_len straddles the launch plan's tile and
               splits (DECODE_STRADDLE), fp32 and bf16, two launches
               bitwise equal; the flash kernel with the causal band and at
               head dim 80 (FLASH_BAND, FLASH_D80: windows 1 to 1000 at a
               ragged S, W >= S bit for bit the call without a band) and
               decode at head dim 80 (DECODE_D80), each also held to a
               float64 evaluation (`band_checks`); then the attention entry
               points (ops.flash_attention, ops.decode_attention) at
               qwen3-4b widths (32 heads, 8 KV heads repeated to 32, head
               dim 128), bf16 and fp32, with their launch counters set to 0
               just before and read just after: prefill q, k, v
               [1, 32, 4096, 128] causal, decode q [8, 32, 128] against a
               [8, 32, 32768, 128] cache at valid_len 30000; each held
               against the plain version (bf16 also row by row, see
               BF16_ROW_TOL; the check is shown to reject a zeroed output,
               for prefill one whose last key tile's V is zeroed (a dropped
               ring stage), for decode one over half the cache and one
               without the last split's slots), and kernel / plain / SDPA /
               bound ms (SDPA is the yardstick only; the port never calls
               it), SDPA also under each backend that takes the call, with
               the kernels its default dispatch ran; decode prints its
               launch plan and is also timed at other n_split
               (DECODE_SPLITS).
  7. train   — full-batch training at phase 4's widths (OR 1.0, k=4, 512,
               3 layers, 16 classes), 5 steps, on expandable allocator
               segments (`gnn_train.TRAIN_ALLOC_CONF`; training comes
               after phases 1-6, which run on the default fixed segments),
               the launch counters set to 0 before and read after each run:
               halo sync on hep100: GAT tiled through the `gnn_train` entry
               point, then GAT scatter, SAGE tiled and SAGE scatter through
               the trainer API on the same book; dense sync: GAT and SAGE
               tiled on that book; ring sync (blockrow): GAT tiled through
               `gnn_train --sync-mode ring`, then GAT scatter and SAGE both
               ways on the ring book.
               Every tiled run launched the kernel for every aggregate
               (`expected_launches`; ring: once a ring stage, k an
               aggregate, at rows 25,600), scatter runs never; within
               LOSS_TOL at every step: tiled == scatter (halo, ring; the
               check shown rejecting a trajectory shifted by one step),
               dense == halo and ring == halo; per-step losses, warm step
               seconds (median of steps 2-5), peak device memory and
               launches per step; every halo and dense path (tiled and
               scatter: the step runs under `minibatch.repeatable_step`)
               and ring GAT tiled (the other ring paths cut for the
               smoke's time) repeats its first REPEAT_STEPS (2) steps'
               losses and final parameters bit for bit; one warm step with and without the
               repeatable step, A B B A on fixed state
               (`repeatable_cost`), on halo GAT tiled and scatter (the
               other paths were cut for phase 17's time); small
               runs (halo, dense, ring) on the card against the same runs
               on the CPU;
               the max aggregate's backward on the card (kernel max and tie
               count) bit for bit against its plain version on an input
               with ties.
  8. minibatch — mini-batch (DistDGL) training at phase 7's widths on OR
               1.0, metis vertex partitions, k=4, fanouts (15, 10, 5),
               global batch 1024 (`MB_WIDTH`), on the same allocator: GAT
               tiled through `gnn_train --regime minibatch --trace` (one
               epoch, serial; its timeline read in phase 11), then GAT scatter and SAGE both ways serial, and
               GAT and SAGE tiled overlapped (prefetch depth 2; the
               scatter paths' overlapped runs cut for the smoke's time),
               MB_STEPS steps each
               through the trainer API, the launch counters set to 0
               before and read after each run. Every tiled run launched
               the kernel as `expected_minibatch_launches` counts, scatter
               runs never; tiled == scatter within LOSS_TOL a step (shown
               rejecting a shifted trajectory); overlapped == serial bit
               for bit on both tiled paths; serial host phases sum to the
               step wall; a small run on the card == the CPU. Prints
               losses, warm step seconds and host phases in both modes,
               overlap efficiency, peak memory and launches per step; then
               which accumulating operations repeat on the card without
               the repeatable step (`determinism_probe`) and, for GAT tiled
               and scatter, the device step's time with and without it on
               two fixed batches, the second timed (runs with it must
               repeat bit for bit).
  9. codecs  — the wire codecs (core/wire.py) at phases 7-8's widths, 5
               steps a path, each beside its fp32 twin of phases 4, 7 and
               8: full batch SAGE halo int8 tiled through `gnn_train
               --codec int8`, GAT halo `variable` past its warmup (tiled
               and scatter), SAGE halo bf16, SAGE dense bf16 and int8, and
               on a ring book SAGE ring bf16 and int8 and GAT ring
               `variable` past its warmup (GAT under int8 on halo or dense
               gives a NaN loss at this size, as the reference's semantics
               do; ROADMAP); mini batch GAT tiled int8 through `gnn_train
               --regime minibatch --codec int8`, then overlapped; serving
               `gnn_serve --codec int8` and `--codec bf16` (GAT tiled).
               The launch counters set to 0 before and read after each
               run. Asserts the launches (`expected_launches`,
               `expected_minibatch_launches`; scatter none); every lossy
               trajectory within CODEC_TOL (mini batch CODEC_TOL_MB) of
               its fp32 twin, bf16 and `variable` within CODEC_TOL_BY,
               int8 on the dense buffer and the ring payload finite only
               (CODEC_UNBOUNDED), tiled == scatter within CODEC_TOL_BY;
               every tiled int8 full-batch path (halo, dense, ring; the
               bf16 and `variable` repeats cut for the smoke's time)
               repeats its 2-step losses, final parameters and final EF
               carry bit for bit; mini-batch
               overlapped == serial bit for bit, wire / miss bytes under
               CODEC_WIRE_RATIO every step; codec fp32 == no codec bit for
               bit (SAGE halo); small runs on the card == the CPU within
               CODEC_CARD_TOL (CODEC_CARD_RUNS: int8 on halo, dense and
               ring). Prints warm step seconds,
               peak GiB and wire MiB beside each fp32 twin, and the phase's
               seconds.
 10. robust  — checkpoints, faults and recovery (ckpt/, fault/) at phases
               7-8's widths, each held to an earlier phase's run of this
               call: full batch GAT tiled halo through `gnn_train
               --ckpt-dir D --inject-fault crash@step:2` (5 epochs) must
               raise `WorkerCrash` after epochs 0-1, then `--resume` trains
               epochs 2-4 equal to phase 7's losses and final parameters
               bit for bit; SAGE halo int8 the same way, its resume with
               `--inject-fault corrupt-ckpt` (restore falls back to epoch
               0), equal to phase 9's int8 losses, parameters and EF carry
               bit for bit; mini batch GAT tiled overlapped through
               `gnn_train --regime minibatch --overlap` crashed at step 3
               and resumed, steps 3-6 equal to phase 8's serial CLI losses
               bit for bit; SAGE tiled serial through the trainer API under
               a sample-error, a fetch-error and a straggler, equal to
               phase 8's losses bit for bit with injected == handled == 3;
               SAGE tiled halo under `run_elastic_fullbatch` losing worker 2
               at epoch 1 and regaining it at epoch 3 (k 4, 3, 3, 4, 4),
               within LOSS_TOL of phase 7's trajectory a step; `gnn_serve`
               GAT tiled with `worker-death@t:1.0,worker:1` and
               `--detect-delay 0.005`, every one of the 200 requests
               answered, some rerouted, injected == handled == 1. The
               launch counters are set to 0 before and read after each run
               and held to `expected_launches` /
               `expected_minibatch_launches` (the elastic run at its k=4
               and k=3 rows, timed in phase 5 from `elastic_shapes`).
               Prints checkpoint bytes, save and restore seconds, each
               step's wall beside phase 8's under the faults, the
               rescales' re-partition seconds, first step after and
               modeled `recovery_time`, the elastic run's peak and the
               serving transition window's modeled p50 / p99.
 11. trace   — observability (obs/, `--trace`, `gnn_trace`), each traced
               run held to its untraced twin of this call: `gnn_train
               --trace` at phase 7's GAT tiled halo CLI run (losses and
               final parameters bit for bit), phase 8's serial mini-batch
               CLI run, which runs traced (its untraced rerun cut for the
               smoke's time: the A B steps below hold traced == untraced),
               `gnn_serve --trace` at phase 4's GAT tiled run
               (embeddings and served logits bit for bit), and `gnn_trace
               --smoke --device cuda` (exit 0, every check ok). Every
               timeline loads through `load_trace`, every reconcile check
               is ok with the byte checks exact, and the launches are
               phases 4, 7 and 8's. Then the tracer's cost on the step
               wall, untraced and traced on fixed state, full batch (GAT
               tiled halo, A B B A) and mini batch (GAT tiled serial, A B:
               cut for phase 17's time). Prints event counts, timeline bytes, the phase
               means and the phase's seconds; the timelines go to
               chiprun_out/trace_*.json.
 12. study   — the paper's study (core/study.py, --out-json, the example
               drivers). The rows that phases 4, 7 and 8's CLI runs wrote
               with --out-json (GAT tiled serving, GAT tiled halo full
               batch, serial GAT tiled mini batch; chiprun_out/
               study_row_*.json) parse as strict JSON and equal the port's
               serializer on inputs recomputed on the host from the run's
               own book and counts: the key set, every computed column
               `==`, the loss bit for bit, the `host_*` columns ==
               `obs.phase_means` of the last epoch's steps. The study rows
               that run a model at STUDY_SMALL (GAT and SAGE tiled, a
               fresh partition cache each): `minibatch_row` with the
               device step, serial and overlapped, `serve_row` under metis,
               hep100 and a worker death, on the card == on the CPU on
               every column outside `study.MEASURED_COLUMNS`. The grid
               (this slice's path, STUDY_GRID): `minibatch_row` overlapped,
               STUDY_GRID_STEPS steps, at phase 8's configuration and
               `serve_row` at phase 4's, for random and metis on one
               partition cache made before phase 5 (`study_shapes`: its
               layer-wise layout is timed there), the launch counters set
               to 0 before and read after each row; `minibatch_speedup`;
               prints speedup, net %, remote %, hit rate, p50 / p99,
               sustainable qps, the host phase means and each row's
               seconds (metis beating random is printed, not gated). Both
               example drivers at their defaults on the card, one process
               each, run beside phase 13's processes (moved there for the
               smoke's time): exit 0 and their regime lines.
 13. lint    — the static-analysis gate (analysis/, `gnn_lint`), each run
               a fresh process, all six started together with phase
               12's two example drivers: `gnn_lint
               --smoke --device cuda` exits 0 with no error, the five
               rules and every program of the CPU grid, no `pallas` cell
               skipped, and every cell that is scatter-free on the card
               (the pallas cells, the tiled ring and mini-batch cells)
               recorded with segment-reduce launches; each of the five
               `--inject-violation` runs on `--grid tiny` exits 1 with
               errors of its own rule alone. The reports go to
               chiprun_out/gnn_lint_*.json; their launches (the fixture's
               tiny shapes, in their own processes) stay out of the
               kernels line. Prints the phase's seconds.
 14. lm      — the LM serving path (models/layers.py, models/lm.py,
               launch/serve.py) at qwen3-4b's full width (36 layers,
               d_model 2560, 32 / 8 heads, head dim 128, d_ff 9728, vocab
               151,936, bf16; random weights from seed 0) through
               `serve.serve(smoke=False)`: batch 8, prompt 2048, 64
               tokens, the routes and both kernels' launch counters set to
               0 before and read after: the flash kernel launched 36 times
               at (BH 256, S 2048, D 128, bf16, causal), the decode kernel
               36 x 63 times at (BH 256, S 2112), the plain route never.
               Prints prefill seconds, decode ms a token a sequence,
               tokens per second, peak memory and the card; each launched
               shape's kernel / plain / SDPA / bound ms (held against its
               plain version), the decode step's GQA repeat of one
               layer's cache, and the shares of prefill and of a decode
               step they take; a warm prefill and decode step run with
               every synchronising operation an error
               (`torch.cuda.set_sync_debug_mode`; shown to reject a step
               that copies from the host), then their wall, device
               busy time (torch.profiler), idle share and top device ops
               (`lm_breakdown`). Then, with the depth cut to 2
               layers (LM_CUT: batch 2, prompt 1024, 4 teacher-forced
               decode steps), bf16 and fp32: the kernel route twice (bitwise
               equal) against the plain route, logits at `_lm_tol`, the
               check shown to reject a zeroed attention output; and
               prefill-then-decode consistency (tests/test_arch_smoke.py's
               check) on the kernel route.
 15. lm families — the VLM, audio, MoE, SSM, hybrid and sliding-window
               paths at full width through `serve.serve(smoke=False)`, one
               arch at a time (qwen2-vl-2b, whisper-tiny,
               deepseek-moe-16b, phi3.5-moe with its depth cut to 4 of 32
               layers, mamba2-370m, hymba-1.5b, h2o-danube-1.8b uncut;
               random weights from seed 0): batch 4, prompt 2048
               (whisper's decoder 448 against its 1536 frames; danube's
               8192, two of its 4096 windows: the flash kernel's band at
               head dim 80, decode over the ring), 16 tokens, the routes
               and launch counters set
               to 0 before and read after: every launch as
               `family_launches` counts (whisper's
               encoder and cross-attention in the flash kernel's full
               mode, its per-step cross-attention on the decode kernel at
               valid_len 1536), the plain route never. Prints prefill
               seconds, the decode step's ms, tokens per second, peak
               memory and the card; a warm decode step run with every
               synchronising operation an error, then its wall, device
               busy time, idle share, aten ops and top device ops; each
               new (kernel, shape) held against its plain version with
               kernel / plain / SDPA / bound ms (SDPA with a boolean band
               mask where the call has a band, its kernels named); hymba's
               full-width prefill past its window (LM_PAST_WINDOW: 4096
               tokens, batch 4, every layer on flash, its windowed ones
               with the band). Then at the full widths
               cut to 2 layers (hymba 5: its 3 global layers and 2
               windowed; danube at prompt 4608, past its window; and
               hymba again at 4096; LM_FAMILY_CUT), bf16 and the same weights in
               fp32: the kernel route twice (bitwise equal) against the
               plain route, fp32 logits at `_lm_tol`, bf16 by mean error
               against the plain fp32 run (at most twice the plain bf16
               run's), each check shown to reject a zeroed attention
               output (mamba2 has none), and prefill-then-decode for all
               but the MoE family (exempt in the reference).
 16. dist    — full-batch training with one process a partition (mode
               "dist", the twin of the reference's shard_map) at phase 7's
               configuration (OR 1.0, hep100 / blockrow, k=4, widths 512,
               3 layers, tiled, seed 0, lr 1e-3): the kernel timed first
               at every (combiner, rows, F) a rank launches it at (rank
               0's layout: a partition's 17,408 halo rows, a chunk's 6,400
               ring rows; `dist_shapes`); then the sim step of the same
               trainer on the card (`DIST_RUNS`: halo SAGE and GAT, 2
               steps, each run twice from scratch; ring GAT, 2 steps, run
               once: cut for the smoke's time), the parent's cached blocks
               released, and 4 ranks spawned on the one card under gloo
               (`launch/ranks.py`, `gnn/dist_jobs.py`). Every rank reports
               the same losses and parameters, a halo run's second run
               repeats its first bit for bit, every rank
               launched the kernel as `expected_launches` counts (ring:
               once a stage) at its rows, a forward hands each rank's
               collectives the accounting's bytes / k, the losses are
               within LOSS_TOL of the sim's and the logits within
               DIST_LOGIT_TOL. Prints each rank's step seconds, the share
               of its wall in staging and gloo, its peak memory and bytes
               a step, beside the sim's step seconds. With a card a rank,
               the NCCL leg runs halo GAT the same way; on one card it
               prints that it did not run, and why.
 17. lm train — LM training (models/lm.py `loss_fn` under remat, the flash
               kernels' autograd Function, optim/): (a) the flash backward
               kernel (csrc/flash_attention_bwd.cu) from the forward
               kernel's out and lse at FLASH_BWD_STRADDLE (Sq = Skv one
               short of and one past its fp32 and bf16 tiles, 31-257, and
               200 against 1000; B 1, H 2, both dtypes) and at
               FLASH_BWD_SHAPES (the step's [2, 32, 2048, 128] causal,
               row 3's [1, 32, 4096, 128] causal and hymba's
               [4, 25, 2048, 64] causal, each bf16 and fp32; whisper's
               full [4, 6, 1536, 64] and 448 against 1536; with the band:
               danube's step [1, 32, 8192, 80] and prefill [4, 32, 8192,
               80] at window 4096 and hymba's train_4k [1, 25, 4096, 64]
               at 2048; FLASH_BWD_BAND, the band and head dim 80 at a
               ragged S): two launches
               bitwise equal, held to its plain version (FLASH_BWD_TOL)
               and to a float64 evaluation (FLASH_BWD_F64_RATIO x the
               plain version's mean error; shown to reject a zeroed dv
               tile), kernel / plain / SDPA-backward / bound ms; the
               forward at row 3's shapes with the lse store off and on
               (A B B A), its lse against the plain version's; the forward
               with the band at FLASH_FWD_BAND_SHAPES (danube's prefill in
               fp32 and at the prefill_32k length, hymba's train_4k)
               against its plain version, with kernel / plain / SDPA
               (band mask) / bound ms. (b)
               qwen3-4b at full width cut to 16 of 36 layers (LM_TRAIN:
               batch 2, seq 2048, remat), 4 steps of `loss_fn` -> autograd
               -> `clip_by_global_norm(1.0)` -> `adam_update(lr 3e-4)`,
               the launch counters and routes set to 0 before and read
               after: the flash forward 2 x 16 a step (the forward pass
               and its recompute), the backward 16, the plain route never;
               finite losses starting near ln V; prints losses, gradient
               norms, step seconds, the warm step and peak memory. (c) at
               2 layers one step's gradients on the kernel route (every
               attention call held to float64, `_checked_attention`, and
               every backward kernel call, bf16 and fp32, so held,
               `_hold_bwd_calls`: a zeroed gradient and, at a windowed
               call, the band dropped shown to be rejected) against the plain route's bf16 and fp32 gradients
               (`_hold_grads`, shown to reject a zeroed gradient); the
               same weights' fp32 gradients on the kernel route (2 fp32
               backward and 4 fp32 forward launches asserted), each leaf
               held to the fp32 plain route's (LM_TRAIN_FP32_GRAD_REL),
               their wall time printed. (d) one more step's gradients
               from the final state, twice, bit for bit. (g) h2o-danube-
               1.8b uncut (LM_TRAIN_UNCUT: 24 layers, batch 1, seq 8192),
               4 steps as (b), launches and routes asserted, finite
               losses from near ln V, warm step and peak printed; then
               (c) at its 2 layers (every attention call on the band at
               head dim 80). (h) hymba at train_4k (LM_TRAIN_4K: 5 of 32
               layers, batch 1, seq 4096): (c) on its windowed and global
               layers. Each cut's kernel-route gradients also repeat bit
               for bit; its fp32 leaves are held to LM_TRAIN_F32_NOISE x
               the fp32 plain route's own conditioning (one ulp on every
               weight, `_f32_conditioning`) + LM_TRAIN_FP32_GRAD_REL. (e) the
               selective remat policy (`lm.set_remat_policy`) at
               mamba2-370m's full width, depth cut to 12 of 48 layers
               for the smoke's time (LM_REMAT,
               batch 1, seq 4096, bf16): the policy off, then "ssm_proj",
               each from seed 2's weights and batch, 1 cold and 1 warm
               step of the same step as (b); losses and gradient norms
               bit for bit between the two, no attention route taken;
               prints each run's warm step, the gradient's peak and the
               step's peak. (f) hymba-1.5b at full width cut to 5 of 32
               layers (LM_REMAT_CUT: 3 global and 2 windowed, batch 1,
               seq 2048, flash on every layer): one step's gradients on
               the kernel route with the policy off and on, every leaf bit
               for bit, the flash forward (2 a layer) and backward (1)
               launches counted from 0 and equal, and the backward one
               `aten.mm` short a block under the policy.

It prints one JSON object {"kernels": [...]} on a line of its own, one
entry per shape of phase 5 with the launches phases 4, 7-11 and 12's grid
made at that shape (phases 7-12 fail if they launched the kernel at a
shape phase 5 did not time),
one per (attention kernel, shape, dtype) of phase 6, one per (kernel,
shape, dtype) phase 14's full-width run launched, and one per (kernel,
shape) phase 15's runs launched (`launches_by_run` by arch, hymba's
prefill past its window as "hymba-1.5b@4096"), one per
per-rank shape phase 16 timed with the launches its ranks made, one per
backward shape of phase 17 (each key's launches from its own run: the
training runs', or for a key no training run launches, fp32 and hymba at
train_4k, the cut's) and its training forwards (lse on; bf16 and the
cuts' fp32) and its forwards with the band, then the
card's name and power limit, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Per-shape results also go to chiprun_out/chip_smoke_kernels.json, the
training results (phase 8's under "minibatch", phase 9's under "codecs",
phase 10's under "robust", phase 11's under "trace", phase 12's under
"study", phase 13's under "lint", phase 14's under "lm", phase 15's
under "lm_families", phase 16's under "dist", phase 17's under
"lm_train") to
chiprun_out/chip_smoke_train.json.
`python3 chip_smoke.py --profile` runs only the device and build phases and
a torch.profiler pass over the GAT main path's layer-wise inference, one
each over a GAT tiled full-batch training step at the training phase's
widths under halo and under ring sync, and one over a serial GAT tiled
mini-batch step at phase 8's.
`python3 chip_smoke.py --aggregate-host` runs only the device and build
phases and `phase_aggregate_host`: the host time a call and a served batch
of `ops.aggregate`'s autograd Function under inference_mode.
`python3 chip_smoke.py --dist` runs only the device and build phases and
phase 16; `--attention`, `--lm-families` and `--lm-train` only them and
phases 6, 15 and 17 (any of the three, in that order).

It exits non-zero when no GPU is visible and when `src/repro_torch` is not
beside it. It imports nothing of JAX and nothing of `repro`.
"""

from __future__ import annotations

import ast
import contextlib
import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
H100_BYTES_PER_S = 3.35e12   # HBM3, H100 SXM data sheet
H100_FP32_FLOPS = 67e12      # fp32 outside the tensor cores, H100 SXM
H100_BF16_FLOPS = 989e12     # bf16 tensor cores, dense, H100 SXM
H100_TF32_FLOPS = 495e12     # TF32 tensor cores, dense, H100 SXM
H100_SMS = 132               # streaming multiprocessors, H100 SXM
SERVE_TOL = dict(rtol=2e-4, atol=2e-4)  # tests/test_gnn_distributed.py:38
# A sum of n unit-normal terms taken in two orders (the kernel's layout
# order, the plain version's atomics) differs by O(sqrt(n)) ulps of the
# partial sums: past this many terms a row's atol grows as sqrt(n / it).
SUM_TERMS_AT_TEST_TOL = 64
# np.add.at, the layout-order oracle of the fp32 sum, takes seconds per
# 1e7 (edge, column) terms: past this many the oracle folds only the first
# columns (a multiple of 8, at least 8), as many as fit; each column is
# folded on its own, so the check of those columns is as strict
FOLD_MAX_TERMS = 1 << 26
KERNEL_TOL = {  # (rtol, atol), tests/test_kernels.py:26,46
    ("sum", "float32"): (1e-5, 8e-5),
    ("max", "float32"): (1e-6, 8e-6),
    ("sum", "bfloat16"): (2e-2, 1.6e-1),
    ("max", "bfloat16"): (2e-2, 1.6e-1),
}
# attention widths of qwen3-4b (src/repro/configs/qwen3_4b.py: num_heads 32,
# num_kv_heads 8, head_dim 128); the KV heads are repeated to 32 before the
# call, as models/layers.py _repeat_kv does
QWEN3_4B = {"num_heads": 32, "num_kv_heads": 8, "head_dim": 128}
PREFILL = {"batch": 1, "seq": 4096}
DECODE = {"batch": 8, "cache": 32768, "valid_len": 30000}
# (rtol, atol) of the attention sweeps, tests/test_kernels.py:198
ATTN_TOL = {"float32": (2e-5, 1e-4), "bfloat16": (3e-2, 0.15)}
# bf16 is also held per output row: the row's largest |kernel - plain| at
# most this share of its largest |plain| value, 4 to 8 bf16 ulps there (an
# ulp is 2^-8 to 2^-7 of a value): both sides round p and the output to
# bf16, in different places, and each can land 1-2 ulps from the exact
# value.
# Past a few hundred keys a whole output row is smaller than the test
# file's 0.15 atol (its rms is about sqrt(e / keys) for unit-normal
# inputs), so that atol alone would pass a zeroed or truncated output;
# this limit does not (checked on the main path).
BF16_ROW_TOL = 2.0 ** -4
# the flash kernel's key tile by dtype (csrc/flash_attention.cu kBfBlockK,
# kF32BlockK); its q tile is 128 rows for both
FLASH_BLOCK_K = {"bfloat16": 128, "float32": 64}
# flash shapes (bh, sq, skv, d, causal) that straddle the 128-row q tile and
# the key tiles: one row or key short of a tile, one past it, one past two;
# and a non-causal Skv past two key tiles that is no multiple of either
STRADDLE = [(2, s, s, d, causal) for s in (127, 129, 257) for d in (64, 128)
            for causal in (True, False)] + [(4, 200, 1000, 64, False),
                                            (4, 200, 1000, 128, False)]
# the decode kernel's tile by dtype and head dim: at most 16 KB of K, a
# multiple of 16 slots (csrc/decode_attention.cu kTile,
# decode_attention._launch_plan)
DECODE_TILE = {"bfloat16": {64: 128, 80: 96, 128: 64},
               "float32": {64: 64, 80: 48, 128: 32}}
# the causal band and head dim 80 (h2o-danube: D 80, window 4096; hymba:
# D 64, window 2048), phase 6: (bh, S, d, window) at a ragged S (1100: no
# multiple of a q or key tile), windows of 1, 100 (inside a tile), 200 and
# 1000 (straddling tile edges), W = S and W > S (no-ops, bit for bit the
# call without a window); head dim 80 also without a band, causal at 257
# and full at Sq 200, Skv 1000 ((bh, sq, skv, causal)); decode at head dim
# 80 at valid_len 1, 700 and S ((bh, S, valids))
FLASH_BAND = [(2, 1100, 64, 1), (2, 1100, 80, 100), (2, 1100, 128, 200),
              (2, 1100, 80, 1000), (2, 1100, 64, 1000), (2, 1100, 80, 1100),
              (2, 1100, 128, 4096)]
FLASH_D80 = [(2, 257, 257, True), (2, 200, 1000, False)]
DECODE_D80 = [(4, 4096, (1, 700, 4096)), (3, 1000, (1, 700, 1000))]
# decode shapes (bh, S, d) whose valid_len sweep straddles the tile and the
# splits of the launch plan (`decode_straddle_valids`): S a multiple of no
# tile; one bh, three, and one past the 256 of the main path
DECODE_STRADDLE = [(bh, 4133, d) for bh in (1, 3, 257) for d in (64, 128)]
# n_split values the main-path decode shape is also timed at, beside the
# plan's
DECODE_SPLITS = (1, 2, 4, 8, 16, 33)
# the training phase: the serving widths, 5 steps; |loss| per step within
# LOSS_TOL (tests/test_gnn_distributed.py:53) between the kernel and the
# scatter path, and between the card and the CPU. The step size is the
# default of Adam's paper (Kingma & Ba, ICLR 2015, Algorithm 1): at the
# reference trainer's 1e-2 the loss diverges here (2.8 -> 142 in 5 steps),
# and a diverging run amplifies last-bit differences tenfold a step
TRAIN_LR = "1e-3"
TRAIN_WIDTH = ["--graph", "OR", "--scale", "1.0", "--partitioner", "hep100",
               "--k", "4", "--features", "512", "--hidden", "512",
               "--layers", "3", "--classes", "16", "--epochs", "5",
               "--lr", TRAIN_LR, "--device", "cuda"]
TRAIN_STEPS = 5
REPEAT_STEPS = 2
LOSS_TOL = 1e-4
# the mini-batch phase (8): phase 7's graph and widths in the DistDGL
# regime: vertex partitions by metis (the reference's tests/test_pipeline.py
# partitioner), k=4, the paper's 3-layer fanouts (15, 10, 5), global batch
# 1024 (the reference's MiniBatchTrainer.build default: 256 seeds a
# worker), one epoch (7 steps); Adam at the CLI's mini-batch default 1e-3,
# the reference trainer's; no feature cache
MB_WIDTH = ["--graph", "OR", "--scale", "1.0", "--partitioner", "metis",
            "--k", "4", "--features", "512", "--hidden", "512",
            "--layers", "3", "--classes", "16", "--regime", "minibatch",
            "--batch", "1024", "--epochs", "1", "--device", "cuda"]
MB_STEPS = 3  # cut from 5, then 4, for the smoke's time: two warm steps
MB_COST_STEPS = 2  # cut from 3 for phase 17's time: one warm step
# the robustness phase (10): the elastic run's smaller cluster (k 4 -> 3 ->
# 4), the faults of its runs, and where its checkpoints go (git-ignored)
ELASTIC_K = 3
ELASTIC_PLAN = ["worker-loss@epoch:1,worker:2", "worker-join@epoch:3"]
# (one fault a step over the MB_STEPS steps of the retried run)
RETRY_PLAN = ["sample-error@step:0,worker:1", "fetch-error@step:1,worker:0",
              "straggler@step:2,worker:2,delay:0.05"]
DEATH_PLAN = ["--inject-fault", "worker-death@t:1.0,worker:1",
              "--detect-delay", "0.005"]
CKPT_ROOT = ROOT / "build" / "chip_smoke_ckpt"
# the final state of the CLI runs phase 10 resumes against (phases 7 and 9
# keep it): run -> (parameters, EF carry), tensors on the card
ORACLES: dict = {}
# phase 8's serial mini-batch CLI run runs traced (`--trace`); phase 11
# checks its timeline and reconcile report and times the tracer on its
# trainer (the untraced rerun phase 11 made was cut for the smoke's time)
TRACED_MB: dict = {}
# the study phase (12): the study rows that phases 4, 7 and 8's CLI runs
# write with --out-json (STUDY_DIR/study_row_*.json), with what phase 12
# recomputes them from on the host (kept by those phases: no device
# tensors); the full-width grid's partition cache (`study_shapes` fills it
# before phase 5); the grid's steps a mini-batch row (cut first if the
# phase runs over its budget, never below 2), and the card-vs-CPU size
STUDY_DIR = ROOT / "chiprun_out"
STUDY_CLI: dict = {}
STUDY_GRID_STEPS = 2  # cut from 3 for phase 17's time
STUDY_GRID_METHODS = ("random", "metis")
# the grid's configuration: phase 8's (MB_WIDTH) for its mini-batch rows,
# phase 4's (FULL_WIDTH) for its serving rows
STUDY_GRID = {"graph": "OR", "scale": 1.0, "k": 4, "feature_dim": 512,
              "hidden_dim": 512, "num_classes": 16, "num_layers": 3,
              "batch": 1024, "qps": 100.0, "requests": 200, "hops": 1,
              "fanout": 10, "max_batch": 32}
STUDY_SMALL = {"graph": "OR", "scale": 0.02, "k": 4, "feature_dim": 16,
               "hidden_dim": 8, "num_classes": 16, "num_layers": 2}
STUDY_SMALL_DEATH = "worker-death@t:0.05,worker:1"
STUDY_EXAMPLES = {
    "torch_gnn_partitioning_study.py": ("DistGNN regime", "DistDGL regime",
                                        "serving regime", "hit_rate"),
    "torch_quickstart.py": ("tiled agg backend == scatter oracle",
                            "minibatch cache=degree")}
STUDY_EXAMPLE_ARGS: list = []  # the drivers' defaults: the card
FULL_WIDTH = ["--graph", "OR", "--scale", "1.0", "--partitioner", "hep100",
              "--k", "4", "--features", "512", "--hidden", "512",
              "--layers", "3", "--classes", "16", "--hops", "1",
              "--fanout", "10", "--batch", "32", "--requests", "200",
              "--device", "cuda"]


def say(*parts) -> None:
    print(*parts, flush=True)


# ---------------------------------------------------------------- phase 1
def phase_device(torch) -> tuple[str, str]:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    say(f"[device] nvidia-smi: {smi}")
    say(f"[device] torch: {kind}, count {torch.cuda.device_count()}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    return smi, kind


# ---------------------------------------------------------------- phase 2
def phase_build(libraries) -> None:
    """Build every kernel library at once (one nvcc each), then load them;
    print each build's time and ptxas report."""
    from repro_torch.kernels._build import build_all

    seconds = build_all(libraries)
    for lib in libraries:
        lib.load()
        say(f"[build] {lib.source.name} in {seconds[lib.name]:.2f}s")
        log = (lib.build_log or "").splitlines()
        for line in log:
            if ("registers" in line or "error" in line.lower()
                    or "Compiling entry" in line or "spill" in line
                    or "wgmma" in line):
                say(f"[build]   {line.strip()}")
        # ptxas serializes the wgmmas (remarks C7512 / C7513) when registers
        # run short or an operand is computed inside a pipeline stage: the
        # kernel stays right but loses its overlap, so the build fails here
        serialized = [ln for ln in log if "serialized" in ln]
        assert not serialized, f"{lib.source.name}: {serialized}"
        # the decode kernel keeps every instantiation free of spills, the
        # flash backward every kernel of both paths (bf16 wgmma: a spill
        # serializes them; fp32 mma.sync: a spill sits in the tile loop)
        if lib.name == "decode_attention":
            spills = [ln.strip() for ln in log
                      if re.search(r"\b[1-9]\d* bytes spill", ln)]
            assert not spills, f"{lib.source.name}: {spills}"
        if lib.name == "flash_attention_bwd" and lib.build_log is not None:
            entries = _spills_by_entry(log)
            # dK / dV and dQ at D 64 and 128 in each path; delta by dtype
            want = {"bf16_kernel": 4, "f32_kernel": 4, "delta": 2}
            paths = {path: [name for name in entries if path in name]
                     for path in want}
            assert all(len(paths[p]) >= n for p, n in want.items()), (
                f"{lib.source.name}: entries {list(entries)}")
            spills = {name: lines for name, lines in entries.items() if lines}
            assert not spills, f"{lib.source.name}: {spills}"


def _spills_by_entry(log) -> dict:
    """{entry function: its ptxas lines that report a non-zero spill} of
    a build log (ptxas reports each entry's properties after the line that
    names it)."""
    out, entry = {}, None
    for line in log:
        found = re.search(r"Compiling entry function '([^']+)'", line)
        if found:
            entry = found.group(1)
            out[entry] = []
        elif entry is not None and re.search(r"\b[1-9]\d* bytes spill",
                                             line):
            out[entry].append(line.strip())
    return out


# ---------------------------------------------------------------- phase 3
def _time_ms(torch, fn, reps: int, warmup: int = 1) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _max_abs_err(torch, a, b) -> float:
    a, b = a.float(), b.float()
    same = a == b  # equal infinities count as no error
    return float(torch.where(same, 0.0, (a - b).abs()).max())


def layout_fold(msgs, ldst, rows, tile_v=256, seg=None):
    """The fp32 sum of a tiled layout in layout order (numpy): np.add.at
    over the real edges, which folds each row's messages one by one in the
    order they stand, from 0, as the kernel does. With `seg` (the segment
    of a launch plan that splits tiles), each `seg`-slot segment of a tile
    is folded that way on its own, and the segments' sums are added in
    order, from 0: the kernel's order then."""
    e, f = msgs.shape
    per_tile = e // (rows // tile_v)
    real = (ldst >= 0) & (ldst < tile_v)
    gdst = (np.arange(e) // per_tile) * tile_v + ldst
    part_of = (np.arange(e) % per_tile) // (seg or per_tile)
    out = np.zeros((rows, f), np.float32)
    for k in range(int(part_of.max()) + 1):
        part = np.zeros((rows, f), np.float32)
        sel = real & (part_of == k)
        np.add.at(part, gdst[sel], msgs[sel].astype(np.float32))
        out = part if part_of.max() == 0 else out + part
    return out


def _hold_exact(torch, out, expect, what) -> None:
    assert out.dtype == expect.dtype and out.shape == expect.shape, what
    if not torch.equal(out, expect):
        bad = int((out != expect).any(dim=1).sum())
        raise AssertionError(f"{what}: {bad} rows differ from the exact "
                             f"oracle")


def _exact_oracle(torch, spmm, msgs, ldst, rows, combiner, tile_v, gdst,
                  lib_msgs):
    """What the kernel must give bit for bit, in its first columns: max,
    scatter_reduce_ amax in fp32 (exact in any order); the fp32 / bf16 sum,
    the layout-order fold in the segments of the kernel's launch plan (the
    plan of the whole width), bf16 rounded once, over the first columns
    that fit FOLD_MAX_TERMS terms."""
    f = msgs.shape[1]
    if combiner == "max":
        exact = torch.full((rows, f), float("-inf"), device=msgs.device)
        exact.scatter_reduce_(0, gdst[:, None].expand(-1, f), lib_msgs.float(),
                              reduce="amax", include_self=True)
        return exact.to(msgs.dtype), "scatter_reduce_ amax"
    cols = f
    if lib_msgs.numel() > FOLD_MAX_TERMS:
        cols = min(f, max(8, FOLD_MAX_TERMS // lib_msgs.shape[0] // 8 * 8))
    n_tiles = rows // tile_v
    plan = spmm._launch_plan(n_tiles, msgs.shape[0] // n_tiles, tile_v, f,
                             msgs.dtype)
    fold = layout_fold(msgs[:, :cols].float().cpu().numpy(),
                       ldst.cpu().numpy(), rows, tile_v, plan.seg)
    return (torch.as_tensor(fold, device=msgs.device).to(msgs.dtype),
            f"layout-order np.add.at in {plan.n_splits} segment(s)"
            + ("" if cols == f else f", columns 0-{cols - 1}"))


def check_kernel(torch, spmm, name, msgs, ldst, rows, combiner, *,
                 tile_v=256, block_e=512, reps=10, show_reject=False):
    """Hold the kernel against its plain version on the same inputs, two
    launches bitwise equal, and against its exact oracle bit for bit
    (`_exact_oracle`; with `show_reject`, that check is shown failing an
    output with one reached row zeroed); time kernel, plain version,
    library call and bound."""
    e, f = msgs.shape
    per_tile = e // (rows // tile_v)
    real = ldst != tile_v
    tile_idx = torch.arange(e, device=msgs.device) // per_tile
    gdst = (tile_idx * tile_v + ldst.long())[real]
    lib_msgs = msgs[real]
    n_real = int(real.sum())
    # the most edges any one row receives
    n_max = int(torch.bincount(gdst, minlength=rows).max()) if n_real else 0

    out = spmm.segment_spmm(msgs, ldst, rows, combiner=combiner,
                            tile_v=tile_v, block_e=block_e)
    again = spmm.segment_spmm(msgs, ldst, rows, combiner=combiner,
                              tile_v=tile_v, block_e=block_e)
    torch.cuda.synchronize()
    assert torch.equal(out, again), f"{name}: repeat differs"
    del again
    exact, exact_by = _exact_oracle(torch, spmm, msgs, ldst, rows, combiner,
                                    tile_v, gdst, lib_msgs)
    cols = exact.shape[1]
    _hold_exact(torch, out[:, :cols], exact, f"{name} {combiner}")
    if show_reject:
        wrong = out[:, :cols].clone()
        wrong[gdst[0]] = 0
        try:
            _hold_exact(torch, wrong, exact, "one row zeroed")
        except AssertionError:
            say(f"[kernels] the exact check rejects {combiner} with "
                f"row {int(gdst[0])} zeroed")
        else:
            raise AssertionError("the exact check passes a zeroed row")
    del exact
    plain = spmm.segment_spmm_plain(msgs, ldst, rows, combiner=combiner,
                                    tile_v=tile_v)
    dtype = str(msgs.dtype).replace("torch.", "")
    rtol, atol = KERNEL_TOL[(combiner, dtype)]
    if combiner == "sum" and n_max > SUM_TERMS_AT_TEST_TOL:
        atol *= math.sqrt(n_max / SUM_TERMS_AT_TEST_TOL)
    torch.testing.assert_close(out.float(), plain.float(), rtol=rtol,
                               atol=atol, equal_nan=False)
    err = _max_abs_err(torch, out, plain)
    lib_out = torch.full((rows, f), 0.0 if combiner == "sum" else
                         float("-inf"), dtype=msgs.dtype, device=msgs.device)
    if combiner == "sum":
        def library():
            lib_out.index_add_(0, gdst, lib_msgs)
    else:
        idx = gdst[:, None].expand(-1, f)

        def library():
            lib_out.scatter_reduce_(0, idx, lib_msgs, reduce="amax",
                                    include_self=True)
    ms = _time_ms(torch, lambda: spmm.segment_spmm(
        msgs, ldst, rows, combiner=combiner, tile_v=tile_v,
        block_e=block_e), reps)
    plain_ms = _time_ms(torch, lambda: spmm.segment_spmm_plain(
        msgs, ldst, rows, combiner=combiner, tile_v=tile_v), max(reps // 3, 1))
    library_ms = _time_ms(torch, library, reps)

    b = msgs.element_size()
    # bytes this run's data needs: the real edges' messages (pad messages
    # are never read), every local_dst, every output row
    nbytes = n_real * f * b + 4 * e + rows * f * b
    ops = n_real * f
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_FP32_FLOPS * 1e3
    row = {
        "shape": name, "combiner": combiner, "dtype": dtype,
        "E_tiled": e, "real_edges": n_real, "rows": rows, "F": f,
        "max_edges_per_row": n_max,
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "library_ms": library_ms, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "tol": [rtol, atol], "repeat_equal": True, "bitwise_vs": exact_by,
    }
    say(f"[kernels] {name:<28} {combiner} {dtype:<8} F={f:<4} "
        f"E_tiled={e:<9} real={n_real:<8} n_max={n_max:<5} err={err:.3g} "
        f"bitwise vs {exact_by}, "
        f"atol={atol:.3g} ms={ms:.4f} "
        f"plain={plain_ms:.4f} library={library_ms:.4f} "
        f"bound={row['bound_ms']:.4f} ({row['bound_by']})")
    return row, out


def _test_layout(torch, tiling, e, v, f, seed, dtype, fill, valid=None,
                 per_tile=None):
    rng = np.random.default_rng(seed)
    dst = rng.integers(0, v, e).astype(np.int32)
    msgs = rng.normal(size=(e, f)).astype(np.float32)
    order, ldst, rows = tiling.prepare_tiled_edges(
        dst, v, valid=valid, per_tile=per_tile)
    msgs_pad = np.concatenate([msgs, np.full((1, f), fill, np.float32)])[order]
    dev = torch.device("cuda")
    return (torch.as_tensor(msgs_pad, device=dev).to(dtype),
            torch.as_tensor(ldst, device=dev), rows, dst)


def or_layout(graph_mod, ep, book_mod, partitioner):
    """The folded [k * E_tiled] local_dst of an edge book over OR scale 1.0,
    k=4 (the main path's graph and k) under `partitioner`."""
    g = graph_mod.paper_graph("OR", scale=1.0, seed=0)
    a = ep.partition_edges(g, 4, partitioner, seed=0)
    book = book_mod.build_edge_book(g, a, 4, tiled_layout=True)
    return book.agg_ldst.reshape(-1), book


def _padding(ldst_np, tile_v=256) -> str:
    real = int((ldst_np != tile_v).sum())
    return (f"E_tiled={ldst_np.size} real={real} "
            f"padding={ldst_np.size / max(real, 1):.3f}x")


def phase_kernels(torch, spmm, tiling, graph_mod, ep, book_mod) -> list:
    rows_out = []
    f32, bf16 = torch.float32, torch.bfloat16
    for combiner, fill in (("sum", 0.0), ("max", float("-inf"))):
        for dtype in (f32, bf16):
            for e, v, f in [(257, 256, 128), (1024, 512, 256), (50, 256, 4),
                            (2000, 768, 128)]:
                msgs, ldst, rows, dst = _test_layout(
                    torch, tiling, e, v, f, e + v + f, dtype, fill)
                row, out = check_kernel(
                    torch, spmm, f"test {e}x{v}", msgs, ldst, rows, combiner,
                    show_reject=(dtype == f32 and e == 257))
                rows_out.append(row)
                # an unreached row comes back as the combiner identity
                unreached = np.setdiff1d(np.arange(rows), dst)
                assert unreached.size > 0
                idx = torch.as_tensor(unreached, device=out.device)
                assert bool((out[idx] == fill).all()), "unreached row"
        # dropped (valid-masked) edges and a forced per_tile
        rng = np.random.default_rng(3)
        valid = rng.random(400) < 0.5
        msgs, ldst, rows, _ = _test_layout(torch, tiling, 400, 300, 8, 3, f32,
                                           fill, valid=valid, per_tile=1024)
        rows_out.append(check_kernel(torch, spmm, "dropped edges", msgs,
                                     ldst, rows, combiner)[0])
    # the -inf pad row passes through a max untouched, even when it is the
    # only message a row sees
    msgs = torch.full((512, 4), float("-inf"), device="cuda")
    ldst = torch.full((512,), 256, dtype=torch.int32, device="cuda")
    ldst[:3] = torch.tensor([0, 0, 5], dtype=torch.int32)
    msgs[1] = 2.0
    out = spmm.segment_spmm(msgs, ldst, 256, combiner="max")
    assert bool((out[0] == 2.0).all()) and bool(torch.isneginf(out[5]).all())
    assert bool(torch.isneginf(out[1:5]).all())
    # the same graph's layout under random edges, beside the main path's
    # (phase 5): the padding a row tile carries depends on the partitioner
    random_ldst, _ = or_layout(graph_mod, ep, book_mod, "random")
    say(f"[kernels] layout under random (OR 1.0, k=4): {_padding(random_ldst)}")
    return rows_out


# ---------------------------------------------------------------- phase 4
@contextlib.contextmanager
def recording(spmm, seen=None):
    """The launch counters set to 0 on entry; the dict yielded holds them
    as read on exit. With `seen`, the local_dst and dtype of the first
    launch at each (combiner, rows, F) are kept there for phase 5."""
    launch = spmm.segment_spmm

    def keep_inputs(messages, local_dst, num_rows, *, combiner="sum", **kw):
        key = (combiner, num_rows, messages.shape[1])
        if key not in seen:
            seen[key] = (local_dst.clone(), messages.dtype, kw)
        return launch(messages, local_dst, num_rows, combiner=combiner, **kw)

    if seen is not None:
        spmm.segment_spmm = keep_inputs
    spmm.LAUNCHES.clear()
    launches = {}
    try:
        yield launches
    finally:
        spmm.segment_spmm = launch
        launches.update(spmm.LAUNCHES)


def serve_once(torch, spmm, gnn_serve, argv, label, seen=None):
    """One gnn_serve run with the launch counters set to 0 just before it
    and read just after (`recording`). Returns the run, its launches and a
    summary (host compute p50, layer seconds, peak, store bytes)."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with recording(spmm, seen) as launches, torch.inference_mode():
        out = gnn_serve.run(argv)
    wall = time.perf_counter() - t0
    rep = out.report
    peak = torch.cuda.max_memory_allocated()
    for e in out.embeddings:
        assert e.shape[0] == out.graph.num_vertices and np.isfinite(e).all()
    assert rep.served() == 200 and np.isfinite(rep.logits).all()
    assert rep.logits.shape == (200, out.spec.num_classes)
    shown = {f"{c} rows={r} F={f}": n for (c, r, f), n in sorted(launches.items())}
    say(f"[serve] {label}: launches {shown}, layer seconds "
        f"{[round(t, 4) for t in out.inference.layer_times]}, host compute "
        f"p50 {np.percentile(rep.host_time, 50) * 1e3:.3f} ms/batch over "
        f"{len(rep.host_time)} batches, peak device memory "
        f"{peak / 2**30:.2f} GiB, served {rep.served()}, modeled p50 "
        f"{rep.p50() * 1e3:.3f} ms p99 {rep.p99() * 1e3:.3f} ms, store miss "
        f"{rep.fetch.miss_bytes / 2**20:.3f} MiB, wire "
        f"{rep.fetch.wire_bytes / 2**20:.3f} MiB, wall {wall:.1f}s")
    summary = {
        "host_compute_p50_ms": float(np.percentile(rep.host_time, 50) * 1e3),
        "layer_seconds": list(out.inference.layer_times),
        "peak_bytes": peak, "miss_bytes": rep.fetch.miss_bytes,
        "wire_bytes": rep.fetch.wire_bytes}
    return out, launches, summary


def _launched(launches, combiner) -> int:
    return sum(n for (c, _, _), n in launches.items() if c == combiner)


def _hold(a, b, what):
    np.testing.assert_allclose(a, b, err_msg=what, **SERVE_TOL)
    diff = float(np.max(np.abs(a - b))) if a.size else 0.0
    say(f"[serve] {what}: max |diff| {diff:.3g} (rtol=atol=2e-4)")


def phase_serve(torch, spmm, gnn_serve) -> tuple[dict, dict, dict]:
    """The main path. Returns the launches of each tiled run by model, the
    inputs of the first launch at each shape (for phase 5) and each tiled
    run's summary (phase 9's fp32 twins)."""
    main_launches, seen, summaries = {}, {}, {}
    row_path = STUDY_DIR / "study_row_serve.json"
    for model in ("gat", "sage"):
        # GAT's run also writes its study row (checked in phase 12)
        out_json = ["--out-json", str(row_path)] if model == "gat" else []
        tiled, launches, summaries[model] = serve_once(
            torch, spmm, gnn_serve,
            FULL_WIDTH + ["--model", model, "--agg-backend", "tiled"]
            + out_json, f"{model} tiled (the kernel)", seen)
        assert _launched(launches, "sum") > 0, f"{model}: sum never launched"
        if model == "gat":
            assert _launched(launches, "max") > 0, "gat: max never launched"
        main_launches[model] = launches
        emb, logits = tiled.embeddings, tiled.report.logits
        ids = tiled.report.served_ids
        if model == "gat":  # phase 11's untraced twin, phase 12's row
            ORACLES["serve gat tiled"] = (emb, logits)
            STUDY_CLI["serve gat tiled"] = {
                "path": row_path, "argv": FULL_WIDTH + ["--model", model,
                                                        "--agg-backend",
                                                        "tiled"],
                "report": tiled.report, "spec": tiled.spec,
                "graph": tiled.graph, "book": tiled.inference.book,
                "partition_time": tiled.partition_time,
                "partition_quality": tiled.partition_quality}
        del tiled
        plain, launches, _ = serve_once(
            torch, spmm, gnn_serve,
            FULL_WIDTH + ["--model", model, "--agg-backend", "scatter"],
            f"{model} scatter (plain)")
        assert not launches, launches
        np.testing.assert_array_equal(ids, plain.report.served_ids)
        for li, (a, b) in enumerate(zip(emb, plain.embeddings)):
            _hold(a, b, f"{model} layer {li} embeddings, kernel vs scatter")
        _hold(logits, plain.report.logits,
              f"{model} served logits, kernel vs scatter")
        del plain, emb, logits

    # a small input, on the card and on the CPU
    small = ["--graph", "OR", "--scale", "0.02", "--k", "4", "--model", "gat",
             "--agg-backend", "tiled", "--features", "32", "--hidden", "32",
             "--layers", "3", "--requests", "60", "--qps", "300"]
    with torch.inference_mode():
        gpu = gnn_serve.run(small + ["--device", "cuda"])
        cpu = gnn_serve.run(small + ["--device", "cpu"])
    for li, (a, b) in enumerate(zip(gpu.embeddings, cpu.embeddings)):
        _hold(a, b, f"small gat layer {li}, card vs cpu")
    _hold(gpu.report.logits, cpu.report.logits, "small gat logits, card vs cpu")
    return main_launches, seen, summaries


# ---------------------------------------------------------------- phase 7
def expandable_segments(torch, gnn_train) -> None:
    """Switch the caching allocator to training's setting (what
    `gnn_train.main` sets for its process) for the allocations that
    follow; the segments cached so far are returned first."""
    torch.cuda.empty_cache()
    torch.cuda.memory._set_allocator_settings(gnn_train.TRAIN_ALLOC_CONF)
    say(f"[train] allocator: {gnn_train.TRAIN_ALLOC_CONF} from here on")


def hold_losses(a, b, what, tol=LOSS_TOL) -> float:
    """Two loss trajectories of one length agree within `tol` at every
    step; returns the largest |difference|."""
    assert len(a) == len(b) > 0, f"{what}: lengths {len(a)}, {len(b)}"
    diff = max(abs(x - y) for x, y in zip(a, b))
    assert np.isfinite(a).all() and np.isfinite(b).all() and diff < tol, (
        f"{what}: max |dloss| {diff:.3g} (limit {tol}): {a} vs {b}")
    return diff


def _layer_launches(spec) -> list:
    """Per layer, the (combiner, F) of each segment-reduce launch of a tiled
    training step: sage/gcn one sum at the layer's input width; gat the
    softmax shift's max (F = heads) and two sums (the denominator, F =
    heads, and the numerator, F = heads x head dim). The backward launches
    none: a sum's transpose is a gather, and the shift takes no gradient."""
    out = []
    for dims in spec.aggregate_dims("halo"):
        combiners = (["max"] + ["sum"] * (len(dims) - 1)
                     if spec.model == "gat" else ["sum"] * len(dims))
        out.append(list(zip(combiners, dims)))
    return out


def expected_launches(spec, steps: int, stages: int = 1) -> dict:
    """The segment-reduce launches of `steps` tiled full-batch steps, by
    (combiner, F) (`_layer_launches`): once an aggregate under halo and
    dense (the k partitions are one stacked launch), once a ring stage
    under ring (`stages` = k; the kernel reduces messages, so F is the
    message width there too)."""
    out = {}
    for layer in _layer_launches(spec):
        for c, f in layer:
            out[(c, f)] = out.get((c, f), 0) + steps * stages
    return out


def expected_minibatch_launches(spec, plan, tiling, k: int,
                                steps: int) -> dict:
    """The segment-reduce launches of `steps` tiled mini-batch steps, by
    (combiner, rows, F): a layer's launches (`_layer_launches`) once per
    worker (`minibatch_loss` runs the k MFGs one by one), at the layer's
    padded rows (the pad plan's n_dst + 1 rounded up to whole row tiles)."""
    out = {}
    for pad, layer in zip(plan.layers, _layer_launches(spec)):
        rows, _ = tiling.tiled_shape(pad.n_dst + 1, 256)
        for c, f in layer:
            out[(c, rows, f)] = out.get((c, rows, f), 0) + steps * k
    return out


def _by_combiner_width(launches) -> dict:
    out = {}
    for (c, _, f), n in launches.items():
        out[(c, f)] = out.get((c, f), 0) + n
    return out


def train_steps(torch, spmm, tr, steps):
    """`steps` steps of trainer `tr` with the launch counters set to 0 just
    before and read just after; host clock around each step (each ends in
    a sync: the loss is read). Returns losses, seconds, launches, peak."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    losses, seconds = [], []
    with recording(spmm) as launches:
        for _ in range(steps):
            t0 = time.perf_counter()
            losses.append(tr.train_step())
            seconds.append(time.perf_counter() - t0)
    return losses, seconds, launches, torch.cuda.max_memory_allocated()


def max_backward_check(torch, spmm, ops, tiling) -> dict:
    """The max aggregate's backward on the card (forward max and tie count
    by the kernel) against the same backward on the CPU (both by the plain
    version), bit for bit, on an input with ties and dropped edges."""
    rng = np.random.default_rng(11)
    e, v, f = 3000, 700, 4
    dst = rng.integers(0, v, e)
    msgs = rng.integers(0, 3, (e, f)).astype(np.float32)  # ties everywhere
    valid = rng.random(e) < 0.9
    order, ldst, rows = tiling.prepare_tiled_edges(dst, v, valid=valid)
    g = rng.normal(size=(v, f)).astype(np.float32)

    def grad_on(device):
        m = torch.tensor(msgs, device=device, requires_grad=True)
        out = ops.aggregate(
            m, torch.as_tensor(dst, device=device), v,
            edge_order=torch.as_tensor(order, dtype=torch.int64,
                                       device=device),
            local_dst=torch.as_tensor(ldst, device=device),
            backend="tiled", reduce="max")
        (gm,) = torch.autograd.grad(out, m, torch.as_tensor(g, device=device))
        return gm

    with recording(spmm) as launches:
        card = grad_on("cuda").cpu()
    assert launches == {("max", rows, f): 1, ("sum", rows, f): 1}, launches
    plain = grad_on("cpu")
    assert torch.equal(card, plain), "max backward: card != plain version"
    # the check has ties to split: rows whose max two or more kept edges hit
    keep = np.zeros((v, f), np.int64)
    top = np.full((v, f), -np.inf, np.float32)
    np.maximum.at(top, dst[valid], msgs[valid])
    np.add.at(keep, dst[valid], msgs[valid] == top[dst[valid]])
    tied = int((keep > 1).sum())
    assert tied > 0 and int((plain != 0).sum()) > 0
    say(f"[train] max backward (E={e}, rows={v}, F={f}, {tied} tied "
        f"(row, column) maxima, ties of {np.unique(keep[keep > 1]).tolist()} "
        f"edges, {int((~valid).sum())} dropped edges): card == plain "
        f"version bit for bit")
    return {"edges": e, "rows": v, "F": f, "tied": tied, "bitwise": True}


def _param_tensors(tr, tree="params") -> list:
    tree = getattr(tr, tree)
    return [] if tree is None else [
        t.detach().clone() for layer in tree["layers"]
        for t in layer.values()]


def repeat_check(torch, spmm, make, losses, what) -> dict:
    """Two fresh REPEAT_STEPS-step runs of trainer factory `make`: their
    losses against each other and against the first steps of `losses`, and
    their final parameters (and, under a lossy codec, their final EF
    carries) against each other, each bit for bit."""
    runs = []
    for _ in range(2):
        tr = make()
        runs.append((train_steps(torch, spmm, tr, REPEAT_STEPS)[0],
                     _param_tensors(tr), _param_tensors(tr, "ef_state")))
        del tr
    (la, pa, ea), (lb, pb, eb) = runs
    same_losses = la == lb == losses[:REPEAT_STEPS]
    same_params = all(torch.equal(x, y) for x, y in zip(pa, pb))
    out = {"rerun_losses_bitwise_equal": same_losses,
           "rerun_params_bitwise_equal": same_params}
    ef_note = ""
    if ea:
        out["rerun_ef_bitwise_equal"] = all(
            torch.equal(x, y) for x, y in zip(ea, eb))
        ef_note = (", final EF carries "
                   + ("bitwise equal" if out["rerun_ef_bitwise_equal"]
                      else "differ"))
    say(f"[train] {what}: two {REPEAT_STEPS}-step reruns "
        f"{'repeat' if same_losses else 'differ from'} the run's losses "
        f"bit for bit ({la}, {lb}), final parameters "
        f"{'bitwise equal' if same_params else 'differ'}{ef_note}")
    return out


def repeatable_cost(torch, make, what) -> dict:
    """What the full-batch step's deterministic algorithms cost: fresh
    trainers from `make` (the same initial state) take one warm step, then
    one timed step, with the repeatable step (`train_step`) and without it
    (`_step`, the same body outside the mode), in the order A B B A (phase
    8's). The timed steps with it must give one loss; without it, whether
    they do is reported."""
    seconds, losses = {True: [], False: []}, {True: [], False: []}
    for on in (True, False, False, True):
        tr = make()
        step = tr.train_step if on else tr._step
        step()
        t0 = time.perf_counter()
        losses[on].append(step())  # the loss is read: the step has ended
        seconds[on].append(time.perf_counter() - t0)
        del tr
    assert losses[True][0] == losses[True][1], (what, losses)
    repeats = losses[False][0] == losses[False][1]
    ratio = float(np.mean(seconds[True]) / np.mean(seconds[False]))
    say(f"[train] {what}: one warm step with the repeatable step "
        f"{seconds[True]} s, without {seconds[False]} s (A B B A, fixed "
        f"state), ratio {ratio:.4f}; without it two runs "
        f"{'repeat bit for bit' if repeats else 'differ'}")
    return {"warm_step_seconds_repeatable": seconds[True],
            "warm_step_seconds_plain": seconds[False], "ratio": ratio,
            "plain_repeats": repeats}


def ring_shapes(torch, gnn_train, fullbatch, tiling, seen) -> None:
    """The ring book of phase 7 built before phase 5, on the host: its
    first stage's folded layout (the k chunks (p, 0), k * R rows) joins
    `seen` at every (combiner, rows, F) a GAT or SAGE tiled ring step
    launches the kernel at, so phase 5 times those shapes on the layout
    phase 7 runs; the layout's padding is printed a stage."""
    args = gnn_train.parser().parse_args(
        TRAIN_WIDTH + ["--model", "gat", "--agg-backend", "tiled",
                       "--sync-mode", "ring"])
    g, _, _, _, spec = gnn_train.problem(args)
    book = fullbatch.build_book(g, None, args.k, sync_mode="ring",
                                tiled_layout=True)
    rows = args.k * tiling.tiled_shape(book.v_block + 1, 256)[0]
    ldst = torch.as_tensor(book.chunk_agg_ldst[:, 0].reshape(-1),
                           device="cuda")
    for model in ("gat", "sage"):
        for c, f in expected_launches(
                dataclasses.replace(spec, model=model), 1):
            seen[(c, rows, f)] = (ldst, torch.float32,
                                  {"tile_v": 256, "block_e": 512})
    chunks = book.chunk_emask.sum(axis=-1)
    say(f"[train] ring layout ({args.graph} {args.scale}, blockrow, "
        f"k={args.k}): v_block {book.v_block}, rows {rows} a stage, c_max "
        f"{book.c_max}, chunk edges {int(chunks.min())}-{int(chunks.max())}; "
        f"per stage "
        + "; ".join(_padding(book.chunk_agg_ldst[:, s].reshape(-1))
                    for s in range(args.k)))


def phase_train(torch, spmm, ops, tiling, gnn_train, fullbatch, models,
                optim) -> tuple[dict, dict]:
    """Full-batch training at full width, 5 steps a path, the launch
    counters set to 0 before and read after each run:
    halo (hep100) GAT tiled through the `gnn_train` entry point, then GAT
    scatter and SAGE both ways through the trainer API on the same book;
    dense GAT and SAGE tiled on that book; ring (blockrow) GAT tiled
    through `gnn_train --sync-mode ring`, then GAT scatter and SAGE both
    ways on the ring book. Holds every tiled run's launches to
    `expected_launches` (ring: k a layer's aggregate, at k * R rows),
    scatter runs to none; within LOSS_TOL at every step: tiled == scatter
    (halo and ring), dense == halo and ring == halo (tiled and scatter);
    every halo and dense path, scatter included, and ring GAT tiled repeat
    their losses and final parameters bit for bit over REPEAT_STEPS steps, and its repeatable step's cost is timed
    (`repeatable_cost`); the card == the CPU at a small size under halo,
    dense and ring; and the max backward on the card == its plain version.
    Returns the results and the launches of each tiled run."""
    runs, main_launches = {}, {}

    def record(key, tr, losses, seconds, launches, peak, wall):
        sync, model, backend = key
        warm = float(np.median(seconds[1:]))
        per_step = {f"{c} F={f}": n / len(losses)
                    for (c, f), n in sorted(_by_combiner_width(
                        launches).items())}
        runs[key] = {
            "losses": losses, "step_seconds": seconds,
            "warm_step_seconds": warm, "peak_bytes": peak,
            "launches_per_step": per_step, "wall_seconds": wall}
        say(f"[train] {sync} {model} {backend}: losses {losses}, step "
            f"seconds {[round(t, 4) for t in seconds]}, warm (median of "
            f"steps 2-{len(seconds)}) {warm:.4f}s, peak device memory "
            f"{peak / 2**30:.2f} GiB, segment-reduce launches per step "
            f"{per_step}, wall {wall:.1f}s")
        if backend == "scatter":
            assert not launches, f"{key} scatter launched {launches}"
            return
        k = tr.book.k
        want = expected_launches(tr.spec, len(losses),
                                 k if sync == "ring" else 1)
        rows = {r for (_, r, _) in launches}
        assert (_by_combiner_width(launches) == want
                and rows == {k * tr.blocks.rows_padded}), (
            f"{key}: launches {launches}, expected {want} at rows "
            f"{k * tr.blocks.rows_padded}")
        main_launches[f"train {sync} {model}"] = launches

    def fresh(base, spec, sync_mode):
        params = models.init_params(spec, seed=0, device=base.blocks.x.device)
        return fullbatch.FullBatchTrainer(
            spec=spec, book=base.book, blocks=base.blocks,
            sync_mode=sync_mode, params=params,
            opt_state=optim.adam_init(params), lr=base.lr)

    def specs_of(base):
        sage = dataclasses.replace(base.spec, model="sage")
        return {("gat", "tiled"): base.spec,
                ("gat", "scatter"): dataclasses.replace(
                    base.spec, agg_backend="scatter"),
                ("sage", "tiled"): sage,
                ("sage", "scatter"): dataclasses.replace(
                    sage, agg_backend="scatter")}

    def cli_run(sync):
        t0 = time.perf_counter()
        # the halo run also writes its study row (checked in phase 12)
        row_path = STUDY_DIR / "study_row_fullbatch.json"
        argv = TRAIN_WIDTH + ["--model", "gat", "--agg-backend", "tiled",
                              "--sync-mode", sync]
        with recording(spmm) as launches:
            run = gnn_train.run(argv + (["--out-json", str(row_path)]
                                        if sync == "halo" else []))
        base = run.trainer  # its book and blocks serve the runs below
        if sync == "halo":
            STUDY_CLI["fullbatch gat tiled halo"] = {
                "path": row_path, "argv": argv, "losses": list(run.losses),
                "spec": run.spec, "graph": run.graph, "book": base.book,
                "assignment": run.assignment}
        record((sync, "gat", "tiled"), base, run.losses, run.step_seconds,
               launches, run.peak_memory, time.perf_counter() - t0)
        ORACLES[f"{sync} gat tiled"] = (_param_tensors(base),
                                        _param_tensors(base, "ef_state"))
        logits = base.forward_logits_global()
        assert logits.shape == (run.graph.num_vertices, 16)
        assert np.isfinite(logits).all()
        return base

    def api_runs(base, sync, keys):
        specs = specs_of(base)
        for key in keys:
            t0 = time.perf_counter()
            tr = fresh(base, specs[key], sync)
            out = train_steps(torch, spmm, tr, TRAIN_STEPS)
            record((sync,) + key, tr, *out, time.perf_counter() - t0)
            del tr

    def repeats(base, sync, keys):
        # every path, scatter included: the step runs under the
        # deterministic algorithms (`minibatch.repeatable_step`)
        specs = specs_of(base)
        for key in keys:
            res = runs[(sync,) + key]
            res.update(repeat_check(
                torch, spmm, lambda: fresh(base, specs[key], sync),
                res["losses"], f"{sync} {key[0]} {key[1]}"))
            assert res["rerun_losses_bitwise_equal"] and \
                res["rerun_params_bitwise_equal"], (
                    f"{sync} {key}: a full-batch path does not repeat bit "
                    "for bit")

    def costs(base, sync, keys):
        specs = specs_of(base)
        for key in keys:
            runs[(sync,) + key]["repeatable_cost"] = repeatable_cost(
                torch, lambda: fresh(base, specs[key], sync),
                f"{sync} {key[0]} {key[1]}")

    def hold(a, b, what):
        diff = hold_losses(runs[a]["losses"], runs[b]["losses"], what)
        runs[a][f"max_abs_dloss_vs_{' '.join(b)}"] = diff
        say(f"[train] {what}: max |dloss| {diff:.3g} over "
            f"{len(runs[a]['losses'])} steps (limit {LOSS_TOL})")

    rest = [("gat", "scatter"), ("sage", "tiled"), ("sage", "scatter")]
    tiled = [("gat", "tiled"), ("sage", "tiled")]
    expandable_segments(torch, gnn_train)
    base = cli_run("halo")
    api_runs(base, "halo", rest)
    api_runs(base, "dense", tiled)
    for model in ("gat", "sage"):
        hold(("halo", model, "tiled"), ("halo", model, "scatter"),
             f"halo {model} tiled vs scatter")
        hold(("dense", model, "tiled"), ("halo", model, "tiled"),
             f"dense {model} vs halo")
    a = runs["halo", "gat", "tiled"]["losses"]
    b = runs["halo", "gat", "scatter"]["losses"]
    try:
        hold_losses(a[1:], b[:-1], "shifted by one step")
    except AssertionError:
        say("[train] the check rejects the tiled trajectory shifted by one "
            "step against scatter's")
    else:
        raise AssertionError("the loss check passes a shifted trajectory")
    repeats(base, "halo", tiled + rest[::2])
    repeats(base, "dense", tiled)
    # the repeatable step's cost A B B A on halo GAT, tiled and scatter,
    # only (cut for phase 17's time): dense's and ring's paths and SAGE's
    # measured the same pattern (tiled 1.000-1.008, scatter 1.26-1.50 on
    # the H100; PERF.md)
    costs(base, "halo", tiled[:1] + rest[:1])
    del base
    torch.cuda.empty_cache()

    ring = cli_run("ring")
    api_runs(ring, "ring", rest)
    for model in ("gat", "sage"):
        hold(("ring", model, "tiled"), ("ring", model, "scatter"),
             f"ring {model} tiled vs scatter")
        for backend in ("tiled", "scatter"):
            hold(("ring", model, backend), ("halo", model, backend),
                 f"ring {model} {backend} vs halo")
    # ring GAT tiled only (cut for the smoke's time: ring SAGE both ways
    # and GAT scatter had repeated bit for bit on the H100; PERF.md)
    repeats(ring, "ring", tiled[:1])
    del ring
    torch.cuda.empty_cache()

    small = ["--graph", "OR", "--scale", "0.02", "--k", "4", "--model", "gat",
             "--agg-backend", "tiled", "--features", "32", "--hidden", "32",
             "--layers", "3", "--epochs", "5"]
    results = {" ".join(key): r for key, r in runs.items()}
    for sync in ("halo", "dense", "ring"):
        argv = small + ["--sync-mode", sync]
        card = gnn_train.run(argv + ["--device", "cuda"]).losses
        cpu = gnn_train.run(argv + ["--device", "cpu"]).losses
        diff = hold_losses(card, cpu, f"small gat {sync}, card vs cpu")
        say(f"[train] small gat {sync} (OR 0.02, width 32), card vs cpu: "
            f"max |dloss| {diff:.3g}")
        results[f"small_{sync}_card_vs_cpu_max_abs_dloss"] = diff
    results["max_backward"] = max_backward_check(torch, spmm, ops, tiling)
    return results, main_launches


# ---------------------------------------------------------------- phase 8
def minibatch_shapes(torch, gnn_train, minibatch, partition_vertices,
                     tiling, seen) -> None:
    """Phase 8's first batch drawn before phase 5, on the host (a CPU
    trainer: no device work): worker 0's tiled layout of each layer joins
    `seen` at every (combiner, rows, F) a GAT or SAGE mini-batch step
    launches the kernel at, so phase 5 times those shapes on a layout the
    sampler made."""
    args = gnn_train.parser().parse_args(
        MB_WIDTH + ["--model", "gat", "--agg-backend", "tiled"])
    g, feats, labels, mask, spec = gnn_train.problem(args)
    a = partition_vertices(g, args.k, args.partitioner, seed=args.seed,
                           train_mask=mask)
    tr = minibatch.MiniBatchTrainer.build(
        g, a, args.k, spec, feats, labels, mask, device="cpu",
        global_batch=args.batch, seed=args.seed)
    pb, _ = tr.engine.next_batch()
    tr.close()
    layer_of = {tiling.tiled_shape(pad.n_dst + 1, 256)[0]: li
                for li, pad in enumerate(tr.plan.layers)}
    keys = set()
    for model in ("gat", "sage"):
        keys |= set(expected_minibatch_launches(
            dataclasses.replace(spec, model=model), tr.plan, tiling, 1, 1))
    for key in sorted(keys):
        ldst = pb.host["layers"][layer_of[key[1]]]["agg_ldst"][0]
        seen[key] = (torch.as_tensor(ldst, device="cuda"), torch.float32,
                     {"tile_v": 256, "block_e": 512})
    say(f"[minibatch] shapes for phase 5 from the first batch (worker 0): "
        f"{sorted(keys)}; plan {[tuple(p) for p in tr.plan.layers]}, "
        f"input vertices {pb.input_vertices.tolist()}, edges "
        f"{pb.edges.tolist()}")


def mb_steps(torch, spmm, tr, steps: int):
    """`steps` steps of mini-batch trainer `tr` with the launch counters set
    to 0 just before and read just after; the engine closed after. Returns
    the StepMetrics, the launches and the peak device memory."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with recording(spmm) as launches:
        try:
            sms = [tr.train_step() for _ in range(steps)]
        finally:
            tr.close()
    return sms, launches, torch.cuda.max_memory_allocated()


def determinism_probe(torch, ref, minibatch, batch, plan) -> dict:
    """Which of the step's accumulating operations repeat bit for bit on
    the card, at layer 0 of worker 0 of a phase-8 batch: `index_add_` (the
    scatter backend's sum, forward) and the transpose of the edge gather
    `h[esrc]` (autograd's `index_put_` accumulate); each run twice without
    and twice with the repeatable step's deterministic algorithms (which
    must repeat)."""
    lay = {n: t[0] for n, t in batch.stacked["layers"][0].items()}
    x = batch.stacked["x"][0]
    n_dst = plan.layers[0].n_dst
    gen = torch.Generator(device=x.device).manual_seed(1)
    msgs = torch.randn(lay["edst"].shape[0], x.shape[1], device=x.device,
                       generator=gen)

    def index_add():
        return ref.segment_sum_ref(msgs, lay["edst"], n_dst + 1)

    def gather_backward():
        h = x.detach().requires_grad_()
        (gh,) = torch.autograd.grad(h[lay["esrc"]], h, msgs)
        return gh

    out = {}
    for name, fn in (("index_add_ (scatter sum)", index_add),
                     ("h[esrc] backward (index_put_ accumulate)",
                      gather_backward)):
        for on in (False, True):
            with minibatch.repeatable_step(on):
                same = torch.equal(fn(), fn())
            out[f"{name}, deterministic={on}"] = same
            say(f"[minibatch] probe {name} at [{msgs.shape[0]}, "
                f"{msgs.shape[1]}], deterministic algorithms {on}: two runs "
                f"{'bitwise equal' if same else 'differ'}")
            assert same or not on, f"{name} differs under the repeatable step"
    return out


def hot_row_probe(torch, ref, minibatch, batch, plan) -> dict:
    """What the pad edges' one hot row costs (reported, not asserted), at
    layer 0 of worker 0 of a phase-8 batch. Every pad edge reads the last
    source row (`esrc` clamped to n_src - 1) and writes the sink row
    (`edst` == n_dst), and a sort-based accumulate walks one row's edges
    one after another. CUDA-event ms of: the transpose of `h[esrc]` as the
    step runs it, and with the pad edges' `esrc` spread over all source
    rows (their messages are masked to zero, so any row gives the same
    values); `index_add_` (the scatter sum) in atomic order, and under
    deterministic algorithms with and without the pad edges."""
    lay = {n: t[0] for n, t in batch.stacked["layers"][0].items()}
    x = batch.stacked["x"][0]
    n_src, n_dst = plan.layers[0].n_src, plan.layers[0].n_dst
    gen = torch.Generator(device=x.device).manual_seed(2)
    msgs = torch.randn(lay["edst"].shape[0], x.shape[1], device=x.device,
                       generator=gen)
    real = lay["emask"]
    pos = torch.arange(real.shape[0], device=x.device)
    spread = torch.where(real, lay["esrc"], pos % n_src)

    def transpose(esrc):
        h = x.detach().requires_grad_()
        return torch.autograd.grad(h[esrc], h, msgs)[0]

    def det(fn):
        def run():
            with minibatch.repeatable_step(True):
                return fn()
        return run

    def add(m, d):
        return lambda: ref.segment_sum_ref(m, d, n_dst + 1)

    ms = {
        "h[esrc] transpose, pad edges on one row": _time_ms(
            torch, lambda: transpose(lay["esrc"]), 3),
        "h[esrc] transpose, pad edges spread": _time_ms(
            torch, lambda: transpose(spread), 3),
        "index_add_, atomic": _time_ms(torch, add(msgs, lay["edst"]), 3),
        "index_add_, deterministic": _time_ms(
            torch, det(add(msgs, lay["edst"])), 3),
        "index_add_, deterministic, real edges only": _time_ms(
            torch, det(add(msgs[real], lay["edst"][real])), 3),
    }
    say(f"[minibatch] hot-row probe at [{msgs.shape[0]}, {msgs.shape[1]}] "
        f"({int((~real).sum())} pad edges of {real.shape[0]}, {n_src} source "
        f"rows), ms: { {k: round(v, 4) for k, v in ms.items()} }")
    return ms


def phase_minibatch(torch, spmm, ref, tiling, gnn_train, minibatch, models,
                    optim) -> tuple[dict, dict]:
    """Mini-batch training at full width (`MB_WIDTH`): GAT tiled through the
    `gnn_train` entry point (one epoch, serial), then GAT scatter, SAGE
    tiled and SAGE scatter serial and GAT and SAGE tiled overlapped
    (prefetch depth 2) through the trainer API on the same book and store, MB_STEPS steps
    each, the launch counters set to 0 before and read after each run.
    Holds every tiled run's launches to `expected_minibatch_launches`,
    scatter runs to none, tiled == scatter within LOSS_TOL a step (the check
    shown rejecting a shifted trajectory), overlapped == serial bit for bit,
    serial phase accounting == the step wall, and the card == the CPU at a
    small size. Then the repeatable step's cost and what it repairs: the
    operation probe, the pad edges' hot-row probe, and per path the device
    step on three batches drawn once, with and without it (A B B A), whose
    runs with it must repeat."""
    runs, main_launches = {}, {}

    def record(key, spec, plan, sms, launches, peak, wall):
        model, backend, mode = key
        losses = [s.loss for s in sms]
        walls = [s.step_wall_host for s in sms]
        warm = float(np.median(walls[1:MB_STEPS]))
        phases = {name: float(np.median([getattr(s, f"{name}_time_host")
                                         for s in sms[1:MB_STEPS]]))
                  for name in ("sample", "fetch", "transfer", "compute")}
        phases["queue_wait"] = float(np.median(
            [s.queue_wait_host for s in sms[1:MB_STEPS]]))
        eff = float(np.mean([s.overlap_efficiency for s in sms[1:MB_STEPS]]))
        per_step = {f"{c} rows={r} F={f}": n / len(sms)
                    for (c, r, f), n in sorted(launches.items())}
        runs[key] = {
            "losses": losses, "step_wall_seconds": walls,
            "warm_step_seconds": warm, "warm_phase_seconds": phases,
            "overlap_efficiency": eff, "peak_bytes": peak,
            "launches_per_step": per_step, "wall_seconds": wall,
            "input_vertices": [s.input_vertices.tolist() for s in sms],
            "edges": [s.edges.tolist() for s in sms]}
        say(f"[minibatch] {model} {backend} {mode}: losses {losses}, step "
            f"seconds {[round(t, 4) for t in walls]}, warm (median of steps "
            f"2-{MB_STEPS}) {warm:.4f}s, warm host phases (s) "
            f"{ {k: round(v, 4) for k, v in phases.items()} }, overlap "
            f"efficiency {eff:.3f}, peak device memory {peak / 2**30:.2f} "
            f"GiB, segment-reduce launches per step {per_step}, wall "
            f"{wall:.1f}s")
        if mode == "serial":
            for s in sms:
                total = (s.sample_time_host + s.fetch_time_host
                         + s.transfer_time_host + s.compute_time_host)
                assert total >= s.step_wall_host * (1 - 1e-9), (key, s)
                assert s.overlap_efficiency == 0.0
        if backend == "scatter":
            assert not launches, f"{key} launched {launches}"
            return
        want = expected_minibatch_launches(spec, plan, tiling, 4, len(sms))
        assert dict(launches) == want, (
            f"{key}: launches {dict(launches)}, expected {want}")
        main_launches[f"minibatch {model} {mode}"] = launches

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    # the run also writes its study row (checked in phase 12) and runs
    # traced (its timeline and reconcile checked in phase 11)
    row_path = STUDY_DIR / "study_row_minibatch.json"
    trace_path = TRACE_DIR / "trace_minibatch.json"
    TRACE_DIR.mkdir(exist_ok=True)
    argv = MB_WIDTH + ["--model", "gat", "--agg-backend", "tiled"]
    with recording(spmm) as launches:
        run = gnn_train.run(argv + ["--out-json", str(row_path),
                                    "--trace", str(trace_path)])
    base = run.trainer
    TRACED_MB.update(path=trace_path, report=run.trace_report,
                     tracer=run.tracer, step_metrics=run.step_metrics,
                     trainer=base, wall=time.perf_counter() - t0)
    STUDY_CLI["minibatch gat tiled serial"] = {
        "path": row_path, "argv": argv, "step_metrics": run.step_metrics,
        "spec": run.spec, "graph": run.graph, "book": base.book,
        "cache_sizes": base.store.cache_sizes.copy(),
        "assignment": run.assignment}
    assert len(run.step_metrics) >= MB_STEPS and run.estimate.step_time > 0
    record(("gat", "tiled", "serial"), base.spec, base.plan,
           run.step_metrics, launches, run.peak_memory,
           time.perf_counter() - t0)
    say(f"[minibatch] modeled paper-cluster step (minibatch_step, last "
        f"step): {run.estimate.step_time * 1e3:.1f} ms")
    del run
    sage = dataclasses.replace(base.spec, model="sage")
    specs = {("gat", "tiled"): base.spec,
             ("gat", "scatter"): dataclasses.replace(base.spec,
                                                     agg_backend="scatter"),
             ("sage", "tiled"): sage,
             ("sage", "scatter"): dataclasses.replace(sage,
                                                      agg_backend="scatter")}

    def fresh(spec, overlap, repeatable=True):
        params = models.init_params(spec, seed=0, device=base.device)
        return dataclasses.replace(
            base, spec=spec, params=params, opt_state=optim.adam_init(params),
            overlap=overlap, prefetch_depth=2, repeatable=repeatable)

    # overlapped on the tiled paths only (cut for the smoke's time: the
    # scatter paths' overlapped runs had equalled their serial ones bit for
    # bit on the H100; PERF.md)
    todo = ([(m, b, "serial") for m, b in specs if (m, b) != ("gat", "tiled")]
            + [(m, b, "overlap") for m, b in specs if b == "tiled"])
    for key in todo:
        t0 = time.perf_counter()
        sms, launches, peak = mb_steps(torch, spmm,
                                       fresh(specs[key[:2]],
                                             key[2] == "overlap"), MB_STEPS)
        record(key, specs[key[:2]], base.plan, sms, launches, peak,
               time.perf_counter() - t0)

    for model in ("gat", "sage"):
        a = runs[model, "tiled", "serial"]["losses"][:MB_STEPS]
        b = runs[model, "scatter", "serial"]["losses"]
        diff = hold_losses(a, b, f"mini-batch {model} tiled vs scatter")
        runs[model, "tiled", "serial"]["max_abs_dloss_vs_scatter"] = diff
        say(f"[minibatch] {model} tiled vs scatter: max |dloss| {diff:.3g} "
            f"over {len(a)} steps (limit {LOSS_TOL})")
    a = runs["gat", "tiled", "serial"]["losses"][:MB_STEPS]
    b = runs["gat", "scatter", "serial"]["losses"]
    try:
        hold_losses(a[1:], b[:-1], "shifted by one step")
    except AssertionError:
        say("[minibatch] the check rejects the tiled trajectory shifted by "
            "one step against scatter's")
    else:
        raise AssertionError("the loss check passes a shifted trajectory")
    for model, backend in [(m, b) for m, b in specs if b == "tiled"]:
        serial = runs[model, backend, "serial"]["losses"][:MB_STEPS]
        over = runs[model, backend, "overlap"]["losses"]
        assert over == serial, (
            f"{model} {backend}: overlapped {over} != serial {serial}")
        say(f"[minibatch] {model} {backend}: overlapped == serial bit for "
            f"bit over {MB_STEPS} steps")

    # what the repeatable step repairs, and what it costs (the batches are
    # drawn overlapped: the same batches, sampled on four threads)
    tr = fresh(base.spec, overlap=True)
    batches = [tr.engine.next_batch()[0] for _ in range(MB_COST_STEPS)]
    tr.close()
    probe = determinism_probe(torch, ref, minibatch, batches[0], base.plan)
    hot = hot_row_probe(torch, ref, minibatch, batches[0], base.plan)
    cost = {}
    # GAT's two backends only (cut for phase 17's time; SAGE's ratios were
    # 1.07 tiled, 13.8-19.4 scatter on the H100: PERF.md)
    for (model, backend), spec in specs.items():
        if model != "gat":
            continue
        seconds, losses = {True: [], False: []}, {True: [], False: []}
        for on in (True, False, False, True):
            tr = fresh(spec, overlap=False, repeatable=on)
            ls, ts = [], []
            for pb in batches:
                t0 = time.perf_counter()
                ls.append(tr.device_step(pb.stacked))
                ts.append(time.perf_counter() - t0)
            losses[on].append(ls)
            seconds[on].append(float(np.median(ts[1:])))
        assert losses[True][0] == losses[True][1], (model, backend, losses)
        repeats = losses[False][0] == losses[False][1]
        on_s, off_s = np.mean(seconds[True]), np.mean(seconds[False])
        cost[f"{model} {backend}"] = {
            "warm_device_step_seconds_repeatable": seconds[True],
            "warm_device_step_seconds_plain": seconds[False],
            "ratio": float(on_s / off_s), "plain_repeats": repeats,
            "losses": {str(k): v for k, v in losses.items()}}
        say(f"[minibatch] {model} {backend}: device step on "
            f"{MB_COST_STEPS} fixed batches, warm (median of steps 2-"
            f"{MB_COST_STEPS}) with the repeatable step {seconds[True]} s, "
            f"without {seconds[False]} s (A B B A), ratio "
            f"{on_s / off_s:.4f}; without it two runs "
            f"{'repeat bit for bit' if repeats else 'differ'}")
    del batches, base

    small = ["--graph", "OR", "--scale", "0.02", "--k", "4", "--model", "gat",
             "--agg-backend", "tiled", "--features", "32", "--hidden", "32",
             "--layers", "3", "--regime", "minibatch", "--partitioner",
             "metis", "--epochs", "5"]
    card = gnn_train.run(small + ["--device", "cuda"]).losses
    cpu = gnn_train.run(small + ["--device", "cpu"]).losses
    diff = hold_losses(card, cpu, "small mini-batch gat, card vs cpu")
    say(f"[minibatch] small gat (OR 0.02, width 32, {len(card)} steps), card "
        f"vs cpu: max |dloss| {diff:.3g}")
    results = {" ".join(k): r for k, r in runs.items()}
    results["small_card_vs_cpu_max_abs_dloss"] = diff
    results["determinism_probe"] = probe
    results["hot_row_probe_ms"] = hot
    results["repeatable_cost"] = cost
    return results, main_launches


# ---------------------------------------------------------------- phase 9
# the codec phase: every lossy loss trajectory within CODEC_TOL (full
# batch; tests/test_wire.py:409) or CODEC_TOL_MB (mini batch; :408) of its
# fp32 twin from phases 7-8, and within its codec's CODEC_TOL_BY where it
# has one; card == CPU within CODEC_CARD_TOL (an int8 level may round the
# other way); mini-batch wire / miss bytes under CODEC_WIRE_RATIO each step
# (:439)
CODEC_TOL = 0.1
CODEC_TOL_MB = 0.05
CODEC_CARD_TOL = 1e-3
CODEC_WIRE_RATIO = 0.3
# bf16 and `variable` (bf16 on the sum exchange past its warmup) moved 8e-5
# to 4e-4 from fp32 in 5 steps at phase 9's widths, int8 on the halo
# exchange 0.0121: this bound sits between them, so a bf16 encode gone as
# coarse as int8 fails it
CODEC_TOL_BY = {"bf16": 5e-3, "variable": 5e-3}
# int8 on the dense buffer or the ring payload passes the gradient to the
# model only through the scale (ROADMAP, reference caveats): SAGE dense
# int8 moved 0.307 from fp32 in 5 steps, so these paths are held to finite
# losses, to repeating bit for bit and to the CPU at a small size, and
# their distance from fp32 is printed, not bounded
CODEC_UNBOUNDED = {("dense", "int8"), ("ring", "int8")}
# the small card == CPU runs: (sync, model, codec) at OR 0.02, widths 32
# (bf16 on dense and ring cut for the smoke's time)
CODEC_CARD_RUNS = [("halo", "gat", "int8"), ("dense", "sage", "int8"),
                   ("ring", "sage", "int8")]


def phase_codecs(torch, spmm, tiling, gnn_train, gnn_serve, fullbatch,
                 models, optim, wire, train, serve_fp32) -> tuple[dict, dict]:
    """The wire codecs at phases 7-8's widths, 5 steps a path, each beside
    its fp32 twin from phases 4, 7 and 8 of this run: full batch (tiled)
    SAGE halo int8 through `gnn_train --codec int8`, then through the
    trainer API on its book GAT halo `variable` past its warmup (tiled and
    scatter), SAGE halo bf16 and SAGE dense bf16 and int8; on a ring
    (blockrow) book SAGE ring bf16 and int8 and GAT ring `variable` past
    its warmup. Left out: GAT under int8 on halo or dense, whose loss is
    NaN at this size, as the reference's is (ROADMAP, reference caveats: a
    row's softmax denominator and numerator are quantised at independent
    scales; `variable`, int8 only on the softmax shift, is the reference's
    answer). Mini batch GAT tiled int8 through
    `gnn_train --regime minibatch --codec int8` (serial), then overlapped;
    serving `gnn_serve --codec int8` and `--codec bf16` (GAT tiled, phase
    4's configuration). The launch counters are set to 0 before and read
    after each run. Holds: launches as `expected_launches` /
    `expected_minibatch_launches` (scatter: none); each lossy trajectory
    within CODEC_TOL (mini batch CODEC_TOL_MB) of its fp32 twin, bf16 and
    `variable` within CODEC_TOL_BY; int8 on the dense buffer or the ring's
    payload, which passes the gradient to the model only by the scale,
    finite only (CODEC_UNBOUNDED); tiled == scatter within CODEC_TOL_BY;
    every tiled int8 full-batch path repeats its losses, final parameters
    and final EF carry bit for bit; mini-batch overlapped == serial bit for
    bit and wire / miss bytes under CODEC_WIRE_RATIO each step; codec fp32
    == no codec bit for bit (SAGE halo, 3 steps); the card == the CPU at a
    small size within CODEC_CARD_TOL on each of CODEC_CARD_RUNS. Prints
    warm step seconds, peak GiB and wire MiB beside each fp32 twin.
    Returns the results and the tiled runs' launches."""
    runs, main_launches = {}, {}
    mib = 2.0 ** 20

    def record(key, tr, losses, seconds, launches, peak, twin, ring=False):
        sync, model, backend, codec = key
        warm = float(np.median(seconds[1:]))
        fp32 = train[twin]
        wire_b = tr.wire_bytes_per_epoch()
        logical = tr.comm_bytes_per_epoch()
        tol = (math.inf if (sync, codec) in CODEC_UNBOUNDED
               else CODEC_TOL_BY.get(codec, CODEC_TOL))
        diff = hold_losses(losses, fp32["losses"], f"{' '.join(key)} vs fp32",
                           tol)
        runs[key] = {
            "losses": losses, "step_seconds": seconds,
            "warm_step_seconds": warm, "peak_bytes": peak,
            "wire_bytes_per_epoch": wire_b,
            "logical_bytes_per_epoch": logical,
            "fp32_twin": twin, "max_abs_dloss_vs_fp32": diff,
            "fp32_warm_step_seconds": fp32["warm_step_seconds"],
            "fp32_peak_bytes": fp32["peak_bytes"]}
        say(f"[codecs] {' '.join(key)}: losses {losses}, warm step "
            f"{warm:.4f}s (fp32 {fp32['warm_step_seconds']:.4f}s), peak "
            f"{peak / 2**30:.2f} GiB (fp32 {fp32['peak_bytes'] / 2**30:.2f}), "
            f"wire {wire_b / mib:.1f} MiB an epoch (fp32 {logical / mib:.1f}; "
            f"analytic), max |dloss| vs fp32 {diff:.3g} (limit {tol})")
        if backend == "scatter":
            assert not launches, f"{key} launched {launches}"
            return
        k = tr.book.k
        want = expected_launches(tr.spec, len(losses), k if ring else 1)
        rows = {r for (_, r, _) in launches}
        assert (_by_combiner_width(launches) == want
                and rows == {k * tr.blocks.rows_padded}), (
            f"{key}: launches {launches}, expected {want}")
        main_launches[f"codec {' '.join(key)}"] = launches

    def fresh(base, spec, sync, codec):
        params = models.init_params(spec, seed=0, device=base.blocks.x.device)
        return fullbatch.FullBatchTrainer(
            spec=spec, book=base.book, blocks=base.blocks, sync_mode=sync,
            params=params, opt_state=optim.adam_init(params), lr=base.lr,
            codec=codec)

    def api_run(base, key, spec, codec, twin, ring=False):
        tr = fresh(base, spec, key[0], codec)
        record(key, tr, *train_steps(torch, spmm, tr, TRAIN_STEPS), twin,
               ring=ring)
        # the int8 paths only (cut for the smoke's time: the bf16 and
        # `variable` paths had repeated bit for bit on the H100; PERF.md)
        if key[2] == "tiled" and key[3] == "int8":
            res = runs[key]
            res.update(repeat_check(
                torch, spmm, lambda: fresh(base, spec, key[0], codec),
                res["losses"], f"codec {' '.join(key)}"))
            assert all(res[f"rerun_{x}_bitwise_equal"]
                       for x in ("losses", "params", "ef")), (
                f"{key}: a tiled lossy path does not repeat bit for bit")
        del tr

    t_phase = time.perf_counter()
    # full batch, halo book (hep100): SAGE int8 through the CLI
    torch.cuda.empty_cache()
    with recording(spmm) as launches:
        run = gnn_train.run(TRAIN_WIDTH + ["--model", "sage", "--agg-backend",
                                           "tiled", "--codec", "int8"])
    base = run.trainer
    ORACLES["codec halo sage tiled int8"] = (_param_tensors(base),
                                             _param_tensors(base, "ef_state"))
    sage = base.spec
    key = ("halo", "sage", "tiled", "int8")
    record(key, base, run.losses, run.step_seconds, launches,
           run.peak_memory, "halo sage tiled")
    assert run.estimate.wire_bytes.sum() < run.estimate.comm_bytes.sum()
    res = runs[key]
    res.update(repeat_check(
        torch, spmm, lambda: fresh(base, sage, "halo", "int8"),
        res["losses"], "codec halo sage tiled int8"))
    assert all(res[f"rerun_{x}_bitwise_equal"]
               for x in ("losses", "params", "ef")), res
    hard = wire.make_codec("variable").at_epoch(2)
    gat = dataclasses.replace(sage, model="gat")
    api_run(base, ("halo", "gat", "tiled", "variable"), gat, hard,
            "halo gat tiled")
    api_run(base, ("halo", "gat", "scatter", "variable"),
            dataclasses.replace(gat, agg_backend="scatter"), hard,
            "halo gat scatter")
    diff = hold_losses(runs["halo", "gat", "tiled", "variable"]["losses"],
                       runs["halo", "gat", "scatter", "variable"]["losses"],
                       "halo gat variable tiled vs scatter",
                       CODEC_TOL_BY["variable"])
    say(f"[codecs] halo gat variable tiled vs scatter: max |dloss| "
        f"{diff:.3g} (limit {CODEC_TOL_BY['variable']})")
    api_run(base, ("halo", "sage", "tiled", "bf16"), sage, "bf16",
            "halo sage tiled")
    api_run(base, ("dense", "sage", "tiled", "bf16"), sage, "bf16",
            "dense sage tiled")
    api_run(base, ("dense", "sage", "tiled", "int8"), sage, "int8",
            "dense sage tiled")
    # the fp32 pin: codec "fp32" == no codec, losses and parameters
    pinned = []
    for codec in (None, "fp32"):
        tr = fresh(base, sage, "halo", codec)
        pinned.append((train_steps(torch, spmm, tr, REPEAT_STEPS)[0],
                       _param_tensors(tr)))
        del tr
    (la, pa), (lb, pb) = pinned
    assert la == lb and all(torch.equal(x, y) for x, y in zip(pa, pb)), (
        f"codec fp32 != no codec: {la} vs {lb}")
    say(f"[codecs] halo sage tiled: codec fp32 == no codec bit for bit over "
        f"{REPEAT_STEPS} steps (losses {la}, final parameters)")
    del base, run
    torch.cuda.empty_cache()

    # full batch, ring book (blockrow): SAGE bf16 and int8, GAT variable
    # past warmup
    args = gnn_train.parser().parse_args(
        TRAIN_WIDTH + ["--model", "gat", "--agg-backend", "tiled",
                       "--sync-mode", "ring"])
    g, feats, labels, mask, spec = gnn_train.problem(args)
    ring = fullbatch.FullBatchTrainer.build(
        g, None, args.k, spec, feats, labels, mask, sync_mode="ring",
        seed=args.seed, lr=float(TRAIN_LR), device=torch.device("cuda"))
    api_run(ring, ("ring", "sage", "tiled", "bf16"), sage, "bf16",
            "ring sage tiled", ring=True)
    api_run(ring, ("ring", "sage", "tiled", "int8"), sage, "int8",
            "ring sage tiled", ring=True)
    api_run(ring, ("ring", "gat", "tiled", "variable"), spec, hard,
            "ring gat tiled", ring=True)
    del ring
    torch.cuda.empty_cache()
    results = {" ".join(k): r for k, r in runs.items()}

    # mini batch: GAT tiled int8 through the CLI (serial), then overlapped
    mb_fp32 = train["minibatch"]["gat tiled serial"]
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    with recording(spmm) as launches:
        run = gnn_train.run(MB_WIDTH + ["--model", "gat", "--agg-backend",
                                        "tiled", "--codec", "int8"])
    base = run.trainer
    want = expected_minibatch_launches(base.spec, base.plan, tiling,
                                       base.book.k, len(run.step_metrics))
    assert dict(launches) == want, (dict(launches), want)
    main_launches["codec minibatch gat int8 serial"] = launches
    serial = run.losses
    diff = hold_losses(serial, mb_fp32["losses"], "minibatch gat int8 vs fp32",
                       CODEC_TOL_MB)
    sms = run.step_metrics
    ratios = [float(s.wire_bytes.sum() / s.miss_bytes.sum()) for s in sms]
    assert max(ratios) < CODEC_WIRE_RATIO, ratios
    warm = float(np.median([s.step_wall_host for s in sms[1:MB_STEPS]]))
    wire_step = float(np.mean([s.wire_bytes.sum() for s in sms]))
    miss_step = float(np.mean([s.miss_bytes.sum() for s in sms]))
    mb = {"losses": serial, "warm_step_seconds": warm,
          "peak_bytes": run.peak_memory, "max_abs_dloss_vs_fp32": diff,
          "wire_over_miss": ratios, "wire_bytes_per_step": wire_step,
          "miss_bytes_per_step": miss_step,
          "fp32_warm_step_seconds": mb_fp32["warm_step_seconds"],
          "fp32_peak_bytes": mb_fp32["peak_bytes"],
          "wall_seconds": time.perf_counter() - t0}
    say(f"[codecs] minibatch gat tiled int8 serial (CLI): losses {serial}, "
        f"warm step {warm:.4f}s (fp32 {mb_fp32['warm_step_seconds']:.4f}s), "
        f"peak {run.peak_memory / 2**30:.2f} GiB (fp32 "
        f"{mb_fp32['peak_bytes'] / 2**30:.2f}), wire {wire_step / mib:.2f} "
        f"MiB a step of {miss_step / mib:.2f} MiB logical miss bytes (ratio "
        f"<= {max(ratios):.4f}), max |dloss| vs fp32 {diff:.3g} (limit "
        f"{CODEC_TOL_MB})")
    params = models.init_params(base.spec, seed=0, device=base.device)
    over = dataclasses.replace(
        base, params=params, opt_state=optim.adam_init(params), overlap=True,
        prefetch_depth=2, ef_state=None)
    sms_o, launches, peak = mb_steps(torch, spmm, over, MB_STEPS)
    assert dict(launches) == expected_minibatch_launches(
        base.spec, base.plan, tiling, base.book.k, MB_STEPS)
    main_launches["codec minibatch gat int8 overlap"] = launches
    over_losses = [s.loss for s in sms_o]
    assert over_losses == serial[:MB_STEPS], (over_losses, serial)
    mb["overlap"] = {
        "losses": over_losses, "peak_bytes": peak,
        "warm_step_seconds": float(np.median(
            [s.step_wall_host for s in sms_o[1:]])),
        "fp32_warm_step_seconds":
            train["minibatch"]["gat tiled overlap"]["warm_step_seconds"]}
    say(f"[codecs] minibatch gat tiled int8 overlapped == serial bit for bit "
        f"over {MB_STEPS} steps; warm step "
        f"{mb['overlap']['warm_step_seconds']:.4f}s (fp32 "
        f"{mb['overlap']['fp32_warm_step_seconds']:.4f}s), peak "
        f"{peak / 2**30:.2f} GiB")
    results["minibatch gat tiled int8"] = mb
    del base, run, over
    torch.cuda.empty_cache()

    # serving: GAT tiled with int8 and bf16 embedding stores
    for codec in ("int8", "bf16"):
        out, launches, summary = serve_once(
            torch, spmm, gnn_serve,
            FULL_WIDTH + ["--model", "gat", "--agg-backend", "tiled",
                          "--codec", codec], f"gat tiled {codec} store")
        assert _launched(launches, "sum") > 0 and _launched(launches, "max")
        main_launches[f"codec serve gat {codec}"] = launches
        fp32 = serve_fp32["gat"]
        assert summary["miss_bytes"] == fp32["miss_bytes"], (summary, fp32)
        if codec == "bf16":
            assert summary["wire_bytes"] * 2 == summary["miss_bytes"]
        else:
            assert summary["wire_bytes"] < CODEC_WIRE_RATIO * summary[
                "miss_bytes"]
        summary["fp32"] = fp32
        results[f"serve gat tiled {codec}"] = summary
        say(f"[codecs] serve gat tiled {codec}: host compute p50 "
            f"{summary['host_compute_p50_ms']:.3f} ms/batch (fp32 "
            f"{fp32['host_compute_p50_ms']:.3f}), peak "
            f"{summary['peak_bytes'] / 2**30:.2f} GiB (fp32 "
            f"{fp32['peak_bytes'] / 2**30:.2f}), wire "
            f"{summary['wire_bytes'] / mib:.3f} MiB (fp32 "
            f"{fp32['wire_bytes'] / mib:.3f})")
        del out

    # small runs on the card and on the CPU
    for sync, model, codec in CODEC_CARD_RUNS:
        small = ["--graph", "OR", "--scale", "0.02", "--k", "4", "--model",
                 model, "--sync-mode", sync, "--agg-backend", "tiled",
                 "--features", "32", "--hidden", "32", "--layers", "3",
                 "--epochs", "5", "--codec", codec]
        card = gnn_train.run(small + ["--device", "cuda"]).losses
        cpu = gnn_train.run(small + ["--device", "cpu"]).losses
        what = f"small {model} {sync} {codec}"
        diff = hold_losses(card, cpu, f"{what}, card vs cpu", CODEC_CARD_TOL)
        say(f"[codecs] {what} (OR 0.02, width 32), card vs cpu: max |dloss| "
            f"{diff:.3g} (limit {CODEC_CARD_TOL})")
        results[f"{what} card vs cpu max_abs_dloss"] = diff
    results["phase_seconds"] = time.perf_counter() - t_phase
    say(f"[codecs] phase 9 took {results['phase_seconds']:.1f}s")
    return results, main_launches


# --------------------------------------------------------------- phase 10
def elastic_shapes(torch, gnn_train, fullbatch, tiling, seen) -> int:
    """Phase 10's k=3 halo book built before phase 5, on the host: its
    stacked layout joins `seen` at every (combiner, rows, F) a SAGE tiled
    halo step launches at k=3 (the elastic run's shrunken cluster), so
    phase 5 times those shapes on the layout phase 10 runs. Returns the
    rows (k x R) of that launch."""
    args = gnn_train.parser().parse_args(
        TRAIN_WIDTH + ["--model", "sage", "--agg-backend", "tiled"])
    g, _, _, _, spec = gnn_train.problem(args)
    assignment = gnn_train.partition_edges(g, ELASTIC_K, args.partitioner,
                                           seed=args.seed)
    book = fullbatch.build_book(g, assignment, ELASTIC_K, sync_mode="halo",
                                tiled_layout=True)
    rows = ELASTIC_K * tiling.tiled_shape(book.v_max + 1, 256)[0]
    ldst = torch.as_tensor(book.agg_ldst.reshape(-1), device="cuda")
    for c, f in expected_launches(spec, 1):
        seen[(c, rows, f)] = (ldst, torch.float32,
                              {"tile_v": 256, "block_e": 512})
    say(f"[robust] elastic layout ({args.graph} {args.scale}, "
        f"{args.partitioner}, k={ELASTIC_K}): rows {rows}, "
        f"{_padding(book.agg_ldst.reshape(-1))}")
    return rows


def _hold_state(torch, got, want, what) -> None:
    """Two lists of tensors equal bit for bit."""
    assert len(got) == len(want) > 0 and all(
        torch.equal(x, y) for x, y in zip(got, want)), (
        f"{what}: not bit for bit")


def phase_robust(torch, spmm, tiling, gnn_train, gnn_serve, models, optim,
                 train, elastic_rows) -> tuple[dict, dict]:
    """Checkpoints, faults and recovery at full width, each run held to an
    earlier phase's run of this call (see the module docstring, phase 10).
    The launch counters are set to 0 before and read after each run.
    Returns the results and the tiled runs' launches."""
    from repro_torch.fault import FaultInjector, FaultPlan, WorkerCrash
    from repro_torch.fault import recovery

    results, main_launches = {}, {}
    shutil.rmtree(CKPT_ROOT, ignore_errors=True)
    t_phase = time.perf_counter()

    def crash(argv, spec_):
        """One gnn_train run that must end in the injected crash; returns
        its launches and wall seconds."""
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        crashed = False
        with recording(spmm) as launches:
            try:
                gnn_train.run(argv + ["--inject-fault", spec_])
            except WorkerCrash:
                crashed = True
        assert crashed, f"{spec_}: the run did not crash"
        return launches, time.perf_counter() - t0

    def resume(argv):
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        with recording(spmm) as launches:
            run = gnn_train.run(argv + ["--resume"])
        return run, launches, time.perf_counter() - t0

    def hold_fb_launches(key, tr, launches, steps):
        want = expected_launches(tr.spec, steps)
        rows = {r for (_, r, _) in launches}
        assert (_by_combiner_width(launches) == want
                and rows == {tr.book.k * tr.blocks.rows_padded}), (
            f"{key}: launches {launches}, expected {want}")
        main_launches[key] = launches

    def ckpt_record(run):
        """(the run's checkpoint results, a line saying them)."""
        ck = run.checkpoints
        return ({"resumed_from": ck.resumed_from, "ckpt_bytes": ck.nbytes,
                 "ckpt_save_seconds": ck.save_seconds,
                 "restore_seconds": ck.restore_seconds},
                f"checkpoint {ck.nbytes / 2**20:.2f} MiB a save, save "
                f"seconds {[round(t, 4) for t in ck.save_seconds]}, restore "
                f"{ck.restore_seconds:.4f}s")

    # full batch, fp32: GAT tiled halo crashed at epoch 2, resumed
    for name, extra_argv, oracle, corrupt in [
            ("halo gat tiled", ["--model", "gat"], "halo gat tiled", False),
            ("halo sage tiled int8", ["--model", "sage", "--codec", "int8"],
             "codec halo sage tiled int8", True)]:
        argv = TRAIN_WIDTH + extra_argv + [
            "--agg-backend", "tiled", "--ckpt-dir", str(CKPT_ROOT / name)]
        crash_launches, crash_wall = crash(argv, "crash@step:2")
        run, launches, wall = resume(
            argv + (["--inject-fault", "corrupt-ckpt"] if corrupt else []))
        tr = run.trainer
        start = 1 if corrupt else 2
        saved, note = ckpt_record(run)
        assert saved["resumed_from"] == start - 1 and \
            run.start_step == start, (name, saved, run.start_step)
        hold_fb_launches(f"robust crash {name}", tr, crash_launches, 2)
        hold_fb_launches(f"robust resume {name}", tr, launches,
                         TRAIN_STEPS - start)
        want = (train["codecs"][name] if corrupt else train[name])["losses"]
        assert run.losses == want[start:], (name, run.losses, want)
        params, ef = ORACLES[oracle]
        _hold_state(torch, _param_tensors(tr), params, f"{name} parameters")
        if ef:
            _hold_state(torch, _param_tensors(tr, "ef_state"), ef,
                        f"{name} EF carry")
        if corrupt:
            plan = run.fault_plan
            assert plan.injected_count == plan.handled_count == 1
        results[f"fullbatch {name}"] = {
            **saved, "losses": run.losses,
            "crash_wall_seconds": crash_wall, "resume_wall_seconds": wall,
            "step_seconds": run.step_seconds, "peak_bytes": run.peak_memory,
            "corrupt_fallback": corrupt}
        say(f"[robust] full batch {name}: crashed after epochs 0-1 "
            f"({crash_wall:.1f}s), resumed from epoch {start - 1}"
            f"{' past a corrupt newest checkpoint' if corrupt else ''}: "
            f"epochs {start}-{TRAIN_STEPS - 1} losses {run.losses} == phase "
            f"{9 if corrupt else 7}'s, final parameters"
            f"{' and EF carry' if ef else ''} bit for bit; {note}"
            f"; step seconds {[round(t, 4) for t in run.step_seconds]}, "
            f"peak {run.peak_memory / 2**30:.2f} GiB, wall {wall:.1f}s")
        del run, tr
    torch.cuda.empty_cache()

    # mini batch: GAT tiled overlapped crashed at step 3, resumed
    argv = MB_WIDTH + ["--model", "gat", "--agg-backend", "tiled",
                       "--overlap", "--ckpt-dir", str(CKPT_ROOT / "mb gat")]
    crash_launches, crash_wall = crash(argv, "crash@step:3")
    run, launches, wall = resume(argv)
    base = run.trainer
    saved, note = ckpt_record(run)
    assert saved["resumed_from"] == 2 and run.start_step == 3, saved
    want = train["minibatch"]["gat tiled serial"]["losses"]
    assert run.losses == want[3:], (run.losses, want)
    for key, got, steps in [("crash", crash_launches, 3),
                            ("resume", launches, len(run.losses))]:
        assert dict(got) == expected_minibatch_launches(
            base.spec, base.plan, tiling, base.book.k, steps), (key, got)
        main_launches[f"robust {key} minibatch gat overlap"] = got
    results["minibatch gat tiled overlap"] = {
        **saved, "losses": run.losses,
        "crash_wall_seconds": crash_wall, "resume_wall_seconds": wall,
        "step_seconds": run.step_seconds}
    say(f"[robust] mini batch gat tiled overlapped: crashed at step 3 "
        f"({crash_wall:.1f}s), resumed from step 2: steps "
        f"3-{2 + len(run.losses)} losses {run.losses} == phase 8's serial "
        f"CLI losses bit for bit; {note}; step seconds "
        f"{[round(t, 4) for t in run.step_seconds]}, wall {wall:.1f}s")
    del run

    # mini batch: SAGE tiled serial through the trainer API, three faults
    # retried or absorbed
    plan = FaultPlan.parse(RETRY_PLAN, seed=0)
    sage = dataclasses.replace(base.spec, model="sage")
    params = models.init_params(sage, seed=0, device=base.device)
    tr = dataclasses.replace(
        base, spec=sage, params=params, opt_state=optim.adam_init(params),
        overlap=False, start_step=0, injector=FaultInjector(plan),
        ef_state=None)
    t0 = time.perf_counter()
    sms, launches, peak = mb_steps(torch, spmm, tr, MB_STEPS)
    wall = time.perf_counter() - t0
    ref = train["minibatch"]["sage tiled serial"]
    losses = [s.loss for s in sms]
    assert losses == ref["losses"], (losses, ref["losses"])
    assert plan.injected_count == plan.handled_count == len(RETRY_PLAN), (
        plan.injected_count, plan.handled_count)
    assert dict(launches) == expected_minibatch_launches(
        sage, base.plan, tiling, base.book.k, MB_STEPS)
    main_launches["robust minibatch sage retried"] = launches
    walls = [s.step_wall_host for s in sms]
    phases = {name: [getattr(s, f"{name}_time_host") for s in sms]
              for name in ("sample", "fetch")}
    results["minibatch sage tiled retried"] = {
        "faults": RETRY_PLAN, "losses": losses, "step_wall_seconds": walls,
        "phase_seconds": phases,
        "fault_free_step_wall_seconds": ref["step_wall_seconds"],
        "peak_bytes": peak, "wall_seconds": wall,
        "injected": plan.injected_count, "handled": plan.handled_count}
    say(f"[robust] mini batch sage tiled serial under {RETRY_PLAN}: losses "
        f"== phase 8's bit for bit, injected == handled == "
        f"{plan.injected_count}; step walls "
        f"{[round(t, 4) for t in walls]}s (phase 8, no faults: "
        f"{[round(t, 4) for t in ref['step_wall_seconds']]}), sample "
        f"{[round(t, 4) for t in phases['sample']]}, fetch "
        f"{[round(t, 4) for t in phases['fetch']]}")
    device = base.device
    del tr, base, sms
    torch.cuda.empty_cache()

    # elastic: SAGE tiled halo, k 4 -> 3 -> 4
    args = gnn_train.parser().parse_args(
        TRAIN_WIDTH + ["--model", "sage", "--agg-backend", "tiled"])
    g, feats, labels, mask, spec = gnn_train.problem(args)
    plan = FaultPlan.parse(ELASTIC_PLAN, seed=0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with recording(spmm) as launches:
        res = recovery.run_elastic_fullbatch(
            g, feats, labels, mask, spec, k=args.k, epochs=TRAIN_STEPS,
            device=device, plan=plan,
            partitioner=args.partitioner, seed=args.seed,
            lr=float(TRAIN_LR))
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    assert res.k_history == [4, 3, 3, 4, 4], res.k_history
    assert plan.injected_count == plan.handled_count == 2
    diff = hold_losses(res.losses, train["halo sage tiled"]["losses"],
                       "elastic sage vs phase 7")
    rows4 = args.k * res.trainer.blocks.rows_padded
    per_k = {args.k: 0, ELASTIC_K: 0}
    for k in res.k_history:
        per_k[k] += 1
    want = {}
    for k, rows in ((args.k, rows4), (ELASTIC_K, elastic_rows)):
        for (c, f), n in expected_launches(spec, per_k[k]).items():
            want[(c, rows, f)] = n
    assert dict(launches) == want, (dict(launches), want)
    main_launches["robust elastic sage"] = launches
    events = [{"epoch": e.epoch, "action": e.action, "old_k": e.old_k,
               "new_k": e.new_k, "repartition_seconds": e.repartition_s,
               "first_step_seconds": e.compile_s,
               "recovery_time_model": e.estimate.recovery_time,
               "restore_time_model": e.estimate.restore_time}
              for e in res.events]
    results["elastic sage tiled halo"] = {
        "plan": ELASTIC_PLAN, "k_history": res.k_history,
        "losses": res.losses, "max_abs_dloss_vs_phase7": diff,
        "events": events, "peak_bytes": peak, "wall_seconds": wall,
        "state_bytes": recovery._state_bytes(res.trainer)}
    say(f"[robust] elastic sage tiled halo: k {res.k_history}, losses "
        f"{res.losses}, max |dloss| vs phase 7 {diff:.3g} (limit "
        f"{LOSS_TOL}); rescales "
        + "; ".join(f"epoch {e['epoch']} {e['action']} {e['old_k']}->"
                    f"{e['new_k']}: re-partition + rebuild "
                    f"{e['repartition_seconds']:.2f}s, first step after "
                    f"{e['first_step_seconds']:.4f}s, modeled recovery "
                    f"{e['recovery_time_model']:.3f}s" for e in events)
        + f"; state {recovery._state_bytes(res.trainer) / 2**20:.2f} MiB, "
        f"peak {peak / 2**30:.2f} GiB, wall {wall:.1f}s")
    del res
    torch.cuda.empty_cache()

    # serving: a worker dies at t=1.0 s
    out, launches, summary = serve_once(
        torch, spmm, gnn_serve,
        FULL_WIDTH + ["--model", "gat", "--agg-backend", "tiled",
                      "--qps", "100"] + DEATH_PLAN,
        "gat tiled, worker 1 dies at t=1.0")
    rep, plan = out.report, out.fault_plan
    assert _launched(launches, "sum") > 0 and _launched(launches, "max") > 0
    main_launches["robust serve gat worker-death"] = launches
    assert rep.dead_worker == 1 and rep.rerouted > 0, rep.rerouted
    assert plan.injected_count == plan.handled_count == 1
    ts = rep.transition_stats()
    results["serve gat tiled worker-death"] = {
        **summary, "served": rep.served(), "rerouted": rep.rerouted,
        "transition": ts}
    say(f"[robust] serve gat tiled, worker {rep.dead_worker} dies at "
        f"t={ts['fault_time']}s: {rep.served()}/200 answered, "
        f"{rep.rerouted} rerouted, transition window "
        f"{ts['window'] * 1e3:.1f} ms over {ts['requests']} requests, "
        f"modeled p50 {ts['p50'] * 1e3:.3f} ms p99 {ts['p99'] * 1e3:.3f} ms")
    del out
    shutil.rmtree(CKPT_ROOT, ignore_errors=True)
    results["phase_seconds"] = time.perf_counter() - t_phase
    say(f"[robust] phase 10 took {results['phase_seconds']:.1f}s")
    return results, main_launches


# ---------------------------------------------------------------- phase 11
# the observability phase: where its timelines go (chiprun_out/ merges back)
TRACE_DIR = ROOT / "chiprun_out"


def _trace_size(path, what) -> dict:
    from repro_torch.obs import load_trace

    payload = load_trace(str(path))
    n = len(payload["traceEvents"])
    size = Path(path).stat().st_size
    say(f"[trace] {what}: {Path(path).name} loads through load_trace, {n} "
        f"trace events, {size} bytes")
    return {"trace_events": n, "trace_bytes": size}


def _held_report(report, path, what) -> dict:
    """Every check of a reconcile report ok, every byte check exact but
    the gradient all-reduce's (the reference prices it at model
    granularity, 25%), and the timeline at `path` through `load_trace`.
    Returns the timeline's sizes and each check's measured / predicted."""
    bad = [(c.quantity, c.level, c.message) for c in report.checks
           if c.level != "ok"]
    assert report.checks and not bad, f"{what}: reconcile {bad}"
    inexact = [c.quantity for c in report.checks
               if c.unit == "bytes" and c.tol_rel != 0.0
               and c.quantity != "allreduce.wire_bytes"]
    assert not inexact, f"{what}: byte checks with a tolerance {inexact}"
    return {**_trace_size(path, what), "checks": {
        c.quantity: [c.measured, c.predicted] for c in report.checks}}


def _same_tensors(torch, got, want, what) -> None:
    assert len(got) == len(want) > 0 and all(
        torch.equal(a, b) for a, b in zip(got, want)), (
            f"{what}: final parameters differ from the untraced twin")


def trace_overhead(torch, obs, make, step, what,
                   order=(False, True, True, False)) -> dict:
    """The tracer's cost on the step wall: fresh trainers from `make` (one
    initial state) take a warm step, then a timed one, untraced and traced
    (a fresh enabled tracer installed for both steps), in `order` (A B B A
    by default). `step(tr)` runs one step and returns (loss, wall seconds).
    The timed losses must be one loss."""
    seconds, losses, events = {False: [], True: []}, [], []
    for traced in order:
        tr = make()
        with obs.tracing() if traced else contextlib.nullcontext() as tracer:
            step(tr)
            loss, wall = step(tr)
            if traced:
                events.append(len(tracer))
        getattr(tr, "close", lambda: None)()
        losses.append(loss)
        seconds[traced].append(wall)
        del tr
    assert len(set(losses)) == 1, f"{what}: traced != untraced {losses}"
    ratio = float(np.mean(seconds[True]) / np.mean(seconds[False]))
    pattern = " ".join("B" if t else "A" for t in order)
    say(f"[trace] {what}: warm step untraced {seconds[False]} s, traced "
        f"{seconds[True]} s ({pattern}, fixed state), ratio {ratio:.4f}, "
        f"{events} events over two traced steps; the losses bit for bit "
        f"equal")
    return {"untraced_seconds": seconds[False],
            "traced_seconds": seconds[True], "ratio": ratio,
            "events_two_steps": events}


def phase_trace(torch, spmm, tiling, gnn_train, gnn_serve, gnn_trace, obs,
                fullbatch, models, optim, train) -> tuple[dict, dict]:
    """Observability (obs/, `--trace`, `gnn_trace`) at phases 4, 7 and 8's
    configurations, each traced run held to its untraced twin of this
    call: `gnn_train --trace` GAT tiled halo (phase 7's CLI run), losses
    and final parameters bit for bit; phase 8's serial mini-batch CLI run,
    which ran traced (its timeline and report read here); `gnn_serve
    --trace` GAT tiled (phase 4's run), embeddings and
    served logits bit for bit; `gnn_trace --smoke --device cuda` exits 0.
    Every timeline loads through `load_trace`, every reconcile check is ok
    (byte checks exact), the launches are phases 4, 7 and 8's; then the
    tracer's cost on the step wall, full batch (A B B A) and mini batch
    (A B, on phase 8's trainer), the losses of traced and untraced steps
    bit for bit equal. Returns the results and the launches of each run."""
    t_phase = time.perf_counter()
    TRACE_DIR.mkdir(exist_ok=True)
    results, main_launches = {}, {}

    # full batch: phase 7's CLI run of GAT tiled halo, traced
    path = TRACE_DIR / "trace_fullbatch.json"
    t0 = time.perf_counter()
    with recording(spmm) as launches:
        run = gnn_train.run(TRAIN_WIDTH + ["--model", "gat", "--agg-backend",
                                           "tiled", "--trace", str(path)])
    wall = time.perf_counter() - t0
    twin = train["halo gat tiled"]
    assert run.losses == twin["losses"], (run.losses, twin["losses"])
    _same_tensors(torch, _param_tensors(run.trainer),
                  ORACLES["halo gat tiled"][0], "traced full batch")
    assert _by_combiner_width(launches) == expected_launches(
        run.trainer.spec, TRAIN_STEPS), launches
    main_launches["trace gnn_train halo gat"] = launches
    res = _held_report(run.trace_report, path,
                       "gnn_train --trace (halo gat tiled)")
    res.update(tracer_events=len(run.tracer), wall_seconds=wall,
               step_seconds=run.step_seconds)
    results["fullbatch halo gat tiled"] = res
    say(f"[trace] gnn_train --trace halo gat tiled: losses and final "
        f"parameters == phase 7's bit for bit, {len(run.tracer)} tracer "
        f"events, reconcile {run.trace_report.counts}, step seconds "
        f"{[round(t, 4) for t in run.step_seconds]} (phase 7: "
        f"{[round(t, 4) for t in twin['step_seconds']]}), wall {wall:.1f}s")
    base = run.trainer
    del run

    def fb_fresh():
        params = models.init_params(base.spec, seed=0,
                                    device=base.blocks.x.device)
        return fullbatch.FullBatchTrainer(
            spec=base.spec, book=base.book, blocks=base.blocks,
            sync_mode="halo", params=params,
            opt_state=optim.adam_init(params), lr=base.lr)

    def fb_step(tr):
        t0 = time.perf_counter()
        loss = tr.train_step()  # the loss is read: the step has ended
        return loss, time.perf_counter() - t0

    results["fullbatch overhead"] = trace_overhead(
        torch, obs, fb_fresh, fb_step, "full batch halo gat tiled")
    del base
    torch.cuda.empty_cache()

    # mini batch: phase 8's serial CLI run of GAT tiled ran traced (its
    # untraced rerun here was cut for the smoke's time; the A B steps
    # below hold traced == untraced bit for bit)
    t = TRACED_MB
    mb = t["trainer"]
    res = _held_report(t["report"], t["path"],
                       "gnn_train --trace (mini batch gat tiled serial)")
    spans = obs.span_summary(t["tracer"].spans())
    res.update(tracer_events=len(t["tracer"]), wall_seconds=t["wall"],
               phase_means=obs.phase_means(t["step_metrics"]),
               span_means={k: v["mean_s"] for k, v in spans.items()})
    results["minibatch gat tiled serial"] = res
    say(f"[trace] gnn_train --trace minibatch gat tiled serial (phase 8's "
        f"run): {len(t['tracer'])} tracer events, reconcile "
        f"{t['report'].counts}, phase means (s) "
        f"{ {k: round(v, 4) for k, v in res['phase_means'].items()} }, "
        f"span means (s) "
        f"{ {k: round(v, 4) for k, v in res['span_means'].items()} }, wall "
        f"{t['wall']:.1f}s")
    TRACED_MB.clear()

    def mb_fresh():
        params = models.init_params(mb.spec, seed=0, device=mb.device)
        return dataclasses.replace(
            mb, params=params, opt_state=optim.adam_init(params),
            overlap=False)

    def mb_step(tr):
        sm = tr.train_step()
        return sm.loss, sm.step_wall_host

    # A B only (cut for phase 17's time): a serial mini-batch step is ~3 s
    results["minibatch overhead"] = trace_overhead(
        torch, obs, mb_fresh, mb_step, "mini batch gat tiled serial",
        order=(False, True))
    del mb
    torch.cuda.empty_cache()

    # serving: phase 4's GAT tiled run, traced
    path = TRACE_DIR / "trace_serve.json"
    t0 = time.perf_counter()
    with recording(spmm) as launches, torch.inference_mode():
        out = gnn_serve.run(FULL_WIDTH + ["--model", "gat", "--agg-backend",
                                          "tiled", "--trace", str(path)])
    wall = time.perf_counter() - t0
    emb, logits = ORACLES["serve gat tiled"]
    for li, (a, b) in enumerate(zip(out.embeddings, emb)):
        np.testing.assert_array_equal(a, b, err_msg=f"traced layer {li}")
    np.testing.assert_array_equal(out.report.logits, logits,
                                  err_msg="traced served logits")
    assert _launched(launches, "sum") > 0 and _launched(launches, "max") > 0
    main_launches["trace gnn_serve gat"] = launches
    res = _held_report(out.trace_report, path,
                       "gnn_serve --trace (gat tiled)")
    res.update(tracer_events=len(out.tracer), wall_seconds=wall,
               request_breakdown=obs.request_breakdown(
                   out.report.latency, out.report.queue_wait))
    results["serve gat tiled"] = res
    say(f"[trace] gnn_serve --trace gat tiled: embeddings and served logits "
        f"== phase 4's bit for bit, {len(out.tracer)} tracer events, "
        f"reconcile {out.trace_report.counts}, wall {wall:.1f}s")
    del out

    # the four reconciled programs of gnn_trace, on the card
    path = TRACE_DIR / "trace_gnn_trace.json"
    report = TRACE_DIR / "trace_gnn_trace.report.json"
    t0 = time.perf_counter()
    with recording(spmm) as launches:
        code = gnn_trace.main(["--smoke", "--device", "cuda", "--out-trace",
                               str(path), "--out-json", str(report)])
    wall = time.perf_counter() - t0
    rep = json.loads(report.read_text())
    assert code == 0 and rep["exit_code"] == 0, rep["counts"]
    assert rep["counts"]["warn"] == rep["counts"]["error"] == 0, rep["counts"]
    assert set(rep["programs"]) == {"fullbatch-halo", "fullbatch-ring",
                                    "minibatch", "serve"}
    main_launches["trace gnn_trace --smoke"] = launches
    res = _trace_size(path, "gnn_trace --smoke --device cuda")
    res.update(counts=rep["counts"], wall_seconds=wall, checks={
        f"{c['program']} {c['quantity']}": [c["measured"], c["predicted"]]
        for c in rep["checks"]})
    results["gnn_trace smoke"] = res
    say(f"[trace] gnn_trace --smoke --device cuda: exit 0, "
        f"{rep['counts']}, wall {wall:.1f}s")

    results["phase_seconds"] = time.perf_counter() - t_phase
    say(f"[trace] phase 11 took {results['phase_seconds']:.1f}s")
    return results, main_launches


# --------------------------------------------------------------- phase 12
def _strict_rows(path) -> list:
    """A study file's rows, parsed as strict JSON: a NaN or Infinity token
    raises."""
    def refuse(name):
        raise ValueError(f"{path}: non-strict JSON token {name}")
    return json.loads(Path(path).read_text(), parse_constant=refuse)


def _as_written(study, rows, name) -> list:
    """`rows` as `study.write_rows` writes them (STUDY_DIR/name), parsed
    back: non-finite floats become null, numpy scalars numbers."""
    path = STUDY_DIR / name
    study.write_rows(rows, str(path))
    return _strict_rows(path)


def _same_row(got, want, measured, what) -> None:
    """Two written rows: one key set, every column outside `measured`
    equal (`==`)."""
    assert set(got) == set(want), (
        f"{what}: columns differ: {sorted(set(got) ^ set(want))}")
    diff = {c: (got[c], want[c]) for c in want
            if c not in measured and got[c] != want[c]}
    assert not diff, f"{what}: {diff}"


def _grid_spec(models):
    gr = STUDY_GRID
    return models.GNNSpec(
        model="gat", feature_dim=gr["feature_dim"],
        hidden_dim=gr["hidden_dim"], num_classes=gr["num_classes"],
        num_layers=gr["num_layers"], agg_backend="tiled")


def study_shapes(torch, study, inference, book_mod, tiling, models,
                 seen) -> object:
    """The full-width grid's partitions made before phase 5, on the host,
    into the partition cache phase 12 then uses (`minibatch_row`'s
    training mask, so its vertex partitions are the grid's). Serving's
    layer-wise inference runs once a cache (its embeddings are memoised
    across methods), on the first method's layout: that layout joins
    `seen` at every (combiner, rows, F) a GAT tiled pass launches, so
    phase 5 times it. The grid's mini-batch steps launch at phase 8's
    rows (the pad plan depends on the batch and fanouts only), which
    `minibatch_shapes` adds. Returns the cache."""
    gr = STUDY_GRID
    cache = study.StudyCache()
    g = cache.graph(gr["graph"], gr["scale"], 0)
    # the draw `study.minibatch_row` makes before it partitions
    mask = np.random.default_rng(1234).random(g.num_vertices) < 0.3
    for method in STUDY_GRID_METHODS:
        rec = cache.vertex_partition(g, method, gr["k"], 0, mask)
        say(f"[study] {method}: partitioned in {rec.partition_time:.2f}s, "
            f"edge cut {rec.metrics.edge_cut:.4f}")
    first = cache.vertex_partition(g, STUDY_GRID_METHODS[0], gr["k"], 0,
                                   mask)
    book = book_mod.build_edge_book(
        g, inference.edge_assignment_from_vertex(g, first.assignment),
        gr["k"], tiled_layout=True)
    rows = gr["k"] * tiling.tiled_shape(book.v_max + 1, 256)[0]
    ldst = torch.as_tensor(book.agg_ldst.reshape(-1), device="cuda")
    keys = [(c, rows, f) for c, f in expected_launches(_grid_spec(models), 1)]
    for key in keys:
        seen.setdefault(key, (ldst, torch.float32,
                              {"tile_v": 256, "block_e": 512}))
    say(f"[study] serving grid's layer-wise layout "
        f"({STUDY_GRID_METHODS[0]}): shapes {keys}; "
        f"{_padding(book.agg_ldst.reshape(-1))}")
    return cache


def study_cli_rows(study, obs, gnn_train, gnn_serve, cost_model,
                   metrics) -> dict:
    """The rows phases 4, 7 and 8's CLI runs wrote with --out-json, each
    parsed as strict JSON and held to the port's serializer on inputs
    recomputed on the host from the run's own book and counts: the key
    set, every computed column `==`, the loss bit for bit, the `host_*`
    columns == `obs.phase_means` of the last epoch's steps."""
    measured = set(study.MEASURED_COLUMNS)
    out = {}

    c = STUDY_CLI["fullbatch gat tiled halo"]
    [row] = _strict_rows(c["path"])
    args = gnn_train.parser().parse_args(c["argv"])
    want = study.fullbatch_result_row(
        args.graph, args.partitioner, args.k, c["spec"],
        metrics=metrics.edge_partition_metrics(c["graph"], c["assignment"],
                                               args.k),
        partition_time=row["partition_time"],
        est=cost_model.fullbatch_epoch(c["book"], c["spec"],
                                       codec=args.codec),
        sync_mode=args.sync_mode, codec=args.codec)
    want["loss"] = c["losses"][-1]
    [want] = _as_written(study, [want], "study_row_fullbatch.recomputed.json")
    _same_row(row, want, measured, "full-batch CLI row")
    assert row["loss"] == c["losses"][-1], (row["loss"], c["losses"])
    out["fullbatch"] = row

    c = STUDY_CLI["minibatch gat tiled serial"]
    [row] = _strict_rows(c["path"])
    args = gnn_train.parser().parse_args(c["argv"])
    g, _, _, mask, _ = gnn_train.problem(args)
    per_epoch = max(int(mask.sum()) // args.batch, 1)
    sms = c["step_metrics"]
    assert len(sms) % per_epoch == 0, (len(sms), per_epoch)
    last = sms[-per_epoch:]

    def mean(name):
        return np.stack([getattr(s, name) for s in last]).mean(axis=0)

    inputs, remote, hits, misses = (mean("input_vertices"),
                                    mean("remote_vertices"),
                                    mean("cache_hits"), mean("remote_misses"))
    est = cost_model.minibatch_step(
        inputs, remote, mean("edges"), c["book"].sizes, c["spec"],
        seeds_per_worker=max(args.batch // args.k, 1),
        remote_miss_vertices=misses, cached_vertices=c["cache_sizes"],
        codec=args.codec)
    host = obs.phase_means(last)
    want = study.minibatch_result_row(
        args.graph, args.partitioner, args.k, c["spec"],
        metrics=metrics.vertex_partition_metrics(g, c["assignment"], args.k,
                                                 mask),
        partition_time=row["partition_time"], batch=args.batch,
        inputs=inputs, remote=remote, hits=hits, misses=misses, est=est,
        steps_per_epoch=per_epoch, cache_policy=args.cache_policy,
        cache_budget=args.cache_budget, overlap=args.overlap,
        prefetch_depth=args.prefetch_depth, host_times=host,
        codec=args.codec)
    want["loss"] = float(np.mean([s.loss for s in last]))
    [want] = _as_written(study, [want], "study_row_minibatch.recomputed.json")
    _same_row(row, want, measured, "mini-batch CLI row")
    assert row["loss"] == want["loss"], (row["loss"], want["loss"])
    for col, value in host.items():
        assert row[col] == value, (col, row[col], value)
    out["minibatch"] = row

    c = STUDY_CLI["serve gat tiled"]
    [row] = _strict_rows(c["path"])
    args = gnn_serve.parser().parse_args(c["argv"])
    g, book, rep = c["graph"], c["book"], c["report"]
    # the replication factor from the run's own edge book: local vertices
    # over the vertices any edge covers
    covered = np.unique(np.concatenate([g.src, g.dst])).shape[0]
    rf = float(book.vmask.sum() / max(covered, 1))
    assert rf == c["partition_quality"] == row["partition_quality"], (
        rf, c["partition_quality"], row["partition_quality"])
    want = study.serve_result_row(
        args.graph, args.partitioner, args.k, c["spec"], rep, qps=args.qps,
        hops=args.hops, fanout=args.fanout, max_batch=args.batch,
        max_wait=args.max_wait, cache_policy=args.cache_policy,
        cache_budget=args.cache_budget, partition_time=row["partition_time"],
        partition_quality=rf, codec=args.codec)
    [want] = _as_written(study, [want], "study_row_serve.recomputed.json")
    _same_row(row, want, measured, "serving CLI row")
    assert row["host_mean"] == float(rep.host_time.mean())
    out["serve"] = row
    for name, r in out.items():
        say(f"[study] CLI row {name}: {len(r)} columns, strict JSON, "
            f"computed columns == the serializer on host inputs"
            + (f", loss {r['loss']!r}" if "loss" in r else "")
            + f", partition {r['partition_time']:.3f}s")
    return out


def study_card_vs_cpu(study, models, fault_plan) -> dict:
    """The study rows that run a model, at STUDY_SMALL (GAT and SAGE
    tiled), each with a fresh partition cache, on the card and on the
    CPU: `minibatch_row(run_device_step=True)` serial and overlapped,
    `serve_row` under metis (vertex) and hep100 (edge) and under a worker
    death. Every column outside MEASURED_COLUMNS equal."""
    measured = set(study.MEASURED_COLUMNS)
    sm = STUDY_SMALL
    where = dict(scale=sm["scale"])
    held = {}
    for model in ("gat", "sage"):
        spec = models.GNNSpec(
            model=model, feature_dim=sm["feature_dim"],
            hidden_dim=sm["hidden_dim"], num_classes=sm["num_classes"],
            num_layers=sm["num_layers"], agg_backend="tiled")

        def mb(overlap):
            return lambda dev: study.minibatch_row(
                sm["graph"], "metis", sm["k"], spec, run_device_step=True,
                overlap=overlap, cache=study.StudyCache(), device=dev,
                **where)

        def serve(method, death=False):
            return lambda dev: study.serve_row(
                sm["graph"], method, sm["k"], spec, n_requests=80,
                qps=400.0, cache=study.StudyCache(), device=dev,
                fault_plan=(fault_plan.parse([STUDY_SMALL_DEATH])
                            if death else None),
                detect_delay=0.005 if death else 0.0, **where)

        calls = {"minibatch serial": mb(False),
                 "minibatch overlap": mb(True),
                 "serve metis": serve("metis"),
                 "serve hep100": serve("hep100"),
                 "serve hep100 worker-death": serve("hep100", death=True)}
        for name, call in calls.items():
            what = f"{model} {name}"
            card, cpu = _as_written(study, [call("cuda"), call("cpu")],
                                    "study_rows_small.json")
            _same_row(card, cpu, measured, f"{what}, card vs cpu")
            held[what] = len(card)
            if "worker-death" in name:
                assert card["rerouted"] > 0 and card["requests"] == 80
    say(f"[study] card == cpu on every computed column ({len(held)} rows, "
        f"OR {sm['scale']}, k={sm['k']}, widths {sm['feature_dim']} / "
        f"{sm['hidden_dim']}): {held}")
    return held


def study_grid(torch, spmm, study, models, cache) -> tuple[dict, dict]:
    """This slice's path at full width on the card: `minibatch_row` (GAT
    tiled, phase 8's configuration, overlapped, STUDY_GRID_STEPS steps)
    and `serve_row` (phase 4's configuration) for each of
    STUDY_GRID_METHODS on one partition cache, then `minibatch_speedup`.
    Prints the paper's columns and each row's seconds. Returns the rows
    and each run's launches (the counters set to 0 just before and read
    just after)."""
    gr, spec = STUDY_GRID, _grid_spec(models)
    where = dict(scale=gr["scale"], cache=cache, device="cuda")
    rows, seconds, launches = {}, {}, {}
    for method in STUDY_GRID_METHODS:
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        with recording(spmm) as n:
            rows[f"minibatch {method}"] = study.minibatch_row(
                gr["graph"], method, gr["k"], spec,
                global_batch=gr["batch"], steps=STUDY_GRID_STEPS,
                run_device_step=True, overlap=True, **where)
        seconds[f"minibatch {method}"] = time.perf_counter() - t0
        assert n, f"study minibatch {method} never launched the kernel"
        launches[f"study minibatch {method}"] = n
    for method in STUDY_GRID_METHODS:
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        with recording(spmm) as n, torch.inference_mode():
            rows[f"serve {method}"] = study.serve_row(
                gr["graph"], method, gr["k"], spec, qps=gr["qps"],
                n_requests=gr["requests"], hops=gr["hops"],
                fanout=gr["fanout"], max_batch=gr["max_batch"], **where)
        seconds[f"serve {method}"] = time.perf_counter() - t0
        assert n, f"study serve {method} never launched the kernel"
        launches[f"study serve {method}"] = n
    speed = {r["method"]: r for r in study.minibatch_speedup(
        [rows[f"minibatch {m}"] for m in STUDY_GRID_METHODS])}
    for method in STUDY_GRID_METHODS:
        r, s = speed[method], rows[f"serve {method}"]
        say(f"[study] {method}: mini batch speedup {r['speedup']:.4f}x, net "
            f"{r['net_pct_random']:.2f}%, remote {r['remote_pct_random']:.2f}"
            f"% of random ({r['remote_vertices']:.1f} remote vertices a "
            f"step), hit rate {r['hit_rate']:.3f}, modeled step "
            f"{r['step_time'] * 1e3:.2f} ms, host phases (s) sample "
            f"{r['host_sample_time']:.4f} fetch {r['host_fetch_time']:.4f} "
            f"transfer {r['host_transfer_time']:.4f} compute "
            f"{r['host_compute_time']:.4f} wall {r['host_step_wall']:.4f} "
            f"overlap efficiency {r['overlap_efficiency']:.3f}, row "
            f"{seconds[f'minibatch {method}']:.1f}s; serving cut "
            f"{s['partition_quality']:.4f}, p50 "
            f"{s['latency_p50'] * 1e3:.3f} ms p99 "
            f"{s['latency_p99'] * 1e3:.3f} ms, sustainable "
            f"{s['qps_sustainable']:.0f} qps, hit rate {s['hit_rate']:.3f}, "
            f"host {s['host_mean'] * 1e3:.3f} ms/batch, row "
            f"{seconds[f'serve {method}']:.1f}s")
    rows = _as_written(study, list(speed.values())
                       + [rows[f"serve {m}"] for m in STUDY_GRID_METHODS],
                       "study_rows_grid.json")
    return {"rows": rows, "seconds": seconds}, launches


def start_examples() -> dict:
    """Both example drivers at their defaults on the card, as a user runs
    them, one process each: {script: (start time, process)}."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    return {script: (time.perf_counter(), subprocess.Popen(
        [sys.executable, str(ROOT / "examples" / script),
         *STUDY_EXAMPLE_ARGS],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=ROOT)) for script in STUDY_EXAMPLES}


def finish_examples(procs) -> dict:
    """The example processes of `start_examples`: each exits 0 and prints
    the lines tests/test_torch_examples.py asserts. Returns the seconds
    each took from its start."""
    out = {}
    for script, (t0, proc) in procs.items():
        text, _ = proc.communicate(timeout=300)
        out[script] = time.perf_counter() - t0
        assert proc.returncode == 0, f"{script}: exit {proc.returncode}" \
            f"\n{text[-3000:]}"
        for line in STUDY_EXAMPLES[script]:
            assert line in text, f"{script}: no {line!r}\n{text[-3000:]}"
        say(f"[study] {script}: exit 0 in {out[script]:.1f}s; "
            + " | ".join(text.strip().splitlines()[-3:]))
    return out


def phase_study(torch, spmm, study, obs, models, gnn_train, gnn_serve,
                cost_model, metrics, fault_plan, cache) -> tuple[dict, dict]:
    """The paper's study on the card (core/study.py, --out-json): the CLI
    rows of phases 4, 7 and 8, the study rows that run a model on the card
    == on the CPU and the full-width grid (the example drivers run beside
    phase 13's processes). Returns the results and the grid's launches."""
    t_phase = time.perf_counter()
    results = {"cli_rows": study_cli_rows(study, obs, gnn_train, gnn_serve,
                                          cost_model, metrics)}
    results["card_vs_cpu"] = study_card_vs_cpu(study, models, fault_plan)
    results["grid"], launches = study_grid(torch, spmm, study, models, cache)
    results["phase_seconds"] = time.perf_counter() - t_phase
    say(f"[study] phase 12 {results['phase_seconds']:.1f}s")
    return results, launches


# ---------------------------------------------------------------- phase 13
LINT_DIR = ROOT / "chiprun_out"
LINT_DEVICE = "cuda"
LINT_RULES = ("collective-budget", "donation", "dtype-policy", "no-scatter",
              "retrace-guard")


def _lint_report(name, proc, path, want_rc) -> dict:
    text, _ = proc.communicate(timeout=600)
    assert proc.returncode == want_rc, (
        f"gnn_lint {name}: exit {proc.returncode}, want {want_rc}\n"
        f"{text[-3000:]}")
    report = json.loads(Path(path).read_text())
    assert report["schema"] == "gnn-lint-report/v1", name
    assert set(report["rules"]) == set(LINT_RULES), (name, report["rules"])
    say(f"[lint] {name}: exit {proc.returncode}; "
        + next(line for line in text.splitlines()
               if line.startswith("gnn_lint:")))
    return report


def phase_lint() -> tuple[dict, dict]:
    """`gnn_lint --smoke` on the card and the five seeded violations on
    its tiny grid, six fresh processes started together (each warms its
    own process before the retrace sweeps count builds), with phase 12's
    two example drivers (`start_examples`) started just before them.
    Returns the results and the examples' seconds."""
    from repro_torch.analysis.programs import build_programs

    t_phase = time.perf_counter()
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    LINT_DIR.mkdir(exist_ok=True)
    runs = {"smoke": ["--smoke"]}
    runs.update({rule: ["--grid", "tiny", "--inject-violation", rule]
                 for rule in LINT_RULES})
    procs, paths, examples = {}, {}, {}
    try:
        examples = start_examples()
        for name, argv in runs.items():
            paths[name] = LINT_DIR / f"gnn_lint_{name}.json"
            procs[name] = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.gnn_lint", *argv,
                 "--device", LINT_DEVICE, "--out-json", str(paths[name])],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                env=env, cwd=ROOT)
        smoke = _lint_report("smoke", procs["smoke"], paths["smoke"], 0)
        for rule in LINT_RULES:
            report = _lint_report(f"--inject-violation {rule}", procs[rule],
                                  paths[rule], 1)
            errs = [f for f in report["findings"] if f["level"] == "error"]
            assert errs and all(f["rule"] == rule for f in errs), (rule, errs)
        examples_seconds = finish_examples(examples)
    finally:
        for proc in [*procs.values(), *(p for _, p in examples.values())]:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    assert smoke["counts"]["error"] == 0, smoke["counts"]
    # the grid's names do not depend on the device; on the CPU the pallas
    # cells are skipped, on the card none may be
    grid = build_programs("smoke", device=LINT_DEVICE)
    assert smoke["programs"] == [p.name for p in grid], smoke["programs"]
    skipped = [f["program"] for f in smoke["findings"]
               if f["message"].startswith("skipped")]
    assert not skipped, f"cells skipped on the card: {skipped}"
    scatter = {f["program"]: f for f in smoke["findings"]
               if f["rule"] == "no-scatter"}
    free = [p.name for p in grid
            if p.kind == "ops" and p.expect_scatter_free]
    assert len(free) == 11 and all(
        "-pallas-" in n or "-tiled-ring-" in n or n.endswith("sage-tiled-fp32")
        for n in free), free
    launches = {}
    for name in free:
        f = scatter[name]
        assert f["level"] == "info" and f["message"] == "scatter-free", f
        launches[name] = f["data"]["kernel_launches"].get(
            "kernel:segment_reduce", 0)
        assert launches[name] > 0, (name, f)
    say(f"[lint] scatter-free on the card with segment-reduce launches: "
        f"{launches}")
    results = {"counts": smoke["counts"], "elapsed_s": smoke["elapsed_s"],
               "programs": len(smoke["programs"]),
               "scatter_free_launches": launches,
               "phase_seconds": time.perf_counter() - t_phase}
    say(f"[lint] phase 13 {results['phase_seconds']:.1f}s (gnn_lint --smoke "
        f"{smoke['elapsed_s']}s of rules; the example drivers beside it)")
    return results, examples_seconds



# --------------------------------------------------------------- phase 14
# the LM serving path: qwen3-4b at full width (src/repro/configs/qwen3_4b.py:
# 36 layers, d_model 2560, 32 heads / 8 KV heads, head dim 128, d_ff 9728,
# vocab 151,936, bf16), random weights from seed 0, through
# `repro_torch.launch.serve.serve`
LM_ARCH = "qwen3-4b"
LM_SERVE = {"batch": 8, "prompt_len": 2048, "gen": 64}
# kernel route against plain route, and prefill-then-decode: the full
# widths with the depth cut to 2 layers, batch 2, a 1024-token prompt and 4
# teacher-forced decode steps, weights from one generator
LM_CUT = {"num_layers": 2, "batch": 2, "prompt_len": 1024, "steps": 4}
# warm decode steps timed for the breakdown (their median)
LM_STEPS_TIMED = 8
# the kernel route's logits against the plain route's (`_lm_tol`): fp32
# at tests/test_kernels.py's 2e-5, of each logit and of the largest; bf16
# at its 3e-2 / 0.15. A zeroed attention output moves the logits by O(1)
# and fails both (`lm_kernel_vs_plain` shows it each run)
LM_F32_TOL = 2e-5
# prefill-then-decode at bf16: the reference's own check's tolerance
# (tests/test_arch_smoke.py:84, "bf16 accumulation-order differences")
LM_CONSISTENCY_BF16 = 0.15
LM_DEVICE = "cuda"


def _lm_tol(dtype, plain) -> tuple[float, float]:
    """(rtol, atol) of logits against the plain route's `plain`."""
    if dtype == "bfloat16":
        return ATTN_TOL["bfloat16"]
    return LM_F32_TOL, LM_F32_TOL * max(1.0, float(plain.float().abs().max()))


def _hold_logits(torch, name, got, plain, dtype) -> float:
    """Hold a run's logits against the plain route's at `_lm_tol`; returns
    the max abs error."""
    rtol, atol = _lm_tol(dtype, plain)
    assert got.shape == plain.shape and got.dtype == plain.dtype, name
    assert bool(torch.isfinite(got.float()).all()), f"{name}: not finite"
    torch.testing.assert_close(got.float(), plain.float(), rtol=rtol,
                               atol=atol, msg=lambda m: f"{name}: {m}")
    return _max_abs_err(torch, got, plain)


@contextlib.contextmanager
def _zeroed_attention(layers):
    """Every `layers.attention` call returns zeros of its output's shape
    (the models look the function up at each call)."""
    orig = layers.attention

    def zeroed(*args, **kwargs):
        out = orig(*args, **kwargs)
        return out.new_zeros(out.shape)

    layers.attention = zeroed
    try:
        yield
    finally:
        layers.attention = orig


def lm_cut_run(torch, lm, cfg, params, tokens, use_pallas):
    """Prefill over the cut's prompt, then its teacher-forced decode steps:
    the logits stacked [steps + 1, B, V]."""
    s, steps = LM_CUT["prompt_len"], LM_CUT["steps"]
    with torch.inference_mode():
        logits, caches = lm.prefill(cfg, params, {"tokens": tokens[:, :s]},
                                    max_len=s + steps, use_pallas=use_pallas)
        outs = [logits]
        for t in range(steps):
            logits, caches = lm.decode_step(
                cfg, params, tokens[:, s + t:s + t + 1], caches, s + t,
                use_pallas=use_pallas)
            outs.append(logits)
    return torch.stack(outs)


def lm_kernel_vs_plain(torch, lm, layers, cfg) -> dict:
    """At LM_CUT, bf16 and fp32: the kernel route twice (bitwise equal,
    every attention call on a kernel) and the plain route, logits held at
    `_lm_tol`, the check shown to reject a zeroed attention output; then
    prefill-then-decode consistency on the kernel route."""
    out = {}
    b, s, steps = LM_CUT["batch"], LM_CUT["prompt_len"], LM_CUT["steps"]
    n_layers = LM_CUT["num_layers"]
    rng = np.random.default_rng(1)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, s + steps)),
                             device=LM_DEVICE)
    for dtype in ("bfloat16", "float32"):
        c = dataclasses.replace(cfg, num_layers=n_layers, dtype=dtype)
        params = lm.init_params(
            c, torch.Generator(device=LM_DEVICE).manual_seed(1), LM_DEVICE)
        layers.ROUTES.clear()
        kern = lm_cut_run(torch, lm, c, params, tokens, None)
        routes = dict(layers.ROUTES)
        assert routes == {"flash": n_layers, "decode": n_layers * steps}, \
            routes
        again = lm_cut_run(torch, lm, c, params, tokens, None)
        assert torch.equal(kern, again), f"lm {dtype}: kernel runs differ"
        plain = lm_cut_run(torch, lm, c, params, tokens, False)
        err = {f"step {i}": _hold_logits(torch, f"lm {dtype} step {i}",
                                         kern[i], plain[i], dtype)
               for i in range(steps + 1)}
        with _zeroed_attention(layers):
            zeroed = lm_cut_run(torch, lm, c, params, tokens, None)
        try:
            _hold_logits(torch, f"lm {dtype} zeroed", zeroed, plain, dtype)
        except AssertionError:
            pass
        else:
            raise AssertionError(f"lm {dtype}: the tolerance passes a run "
                                 "whose attention output is zeroed")
        zero_err = _max_abs_err(torch, zeroed, plain)
        # prefill-then-decode: decoding token s after a prefill of s tokens
        # gives the logits of a prefill over s + 1 tokens
        with torch.inference_mode():
            _, caches = lm.prefill(c, params, {"tokens": tokens[:, :s]},
                                   max_len=s + 8)
            dec, _ = lm.decode_step(c, params, tokens[:, s:s + 1], caches, s)
            full, _ = lm.prefill(c, params, {"tokens": tokens[:, :s + 1]},
                                 max_len=s + 8)
        if dtype == "bfloat16":
            torch.testing.assert_close(
                dec.float(), full.float(), rtol=LM_CONSISTENCY_BF16,
                atol=LM_CONSISTENCY_BF16)
        else:
            _hold_logits(torch, "lm float32 prefill-then-decode", dec, full,
                         dtype)
        consistency = _max_abs_err(torch, dec, full)
        out[dtype] = {"max_abs_err": err, "zeroed_max_abs_err": zero_err,
                      "consistency_max_abs_err": consistency,
                      "logit_max": float(plain.float().abs().max())}
        say(f"[lm] kernel vs plain {dtype} (2 layers, batch {b}, prompt {s},"
            f" {steps} decode steps): max |err| by step "
            + ", ".join(f"{e:.3g}" for e in err.values())
            + f" (largest |logit| {out[dtype]['logit_max']:.3g}); zeroed "
            f"attention {zero_err:.3g}, rejected; prefill-then-decode "
            f"{consistency:.3g}")
        del params, kern, again, plain, zeroed
        torch.cuda.empty_cache()
    return out


def lm_kernel_entries(torch, flash, decode, layers, cfg, launches) -> tuple:
    """The kernels line's entries for the (kernel, shape, dtype) pairs the
    full-width run launched (`lm_shape_entries`), and the decode step's
    GQA repeat of one layer's cache, timed."""
    b, s, gen = LM_SERVE["batch"], LM_SERVE["prompt_len"], LM_SERVE["gen"]
    h, kvh, d = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    shapes = {(kernel, key): {"launches_by_run": {LM_ARCH: n}, "b": b,
                              "h": h, "kvh": kvh, "valid": s + gen - 1}
              for kernel, table in launches.items()
              for key, n in table.items()}
    entries, rows = lm_shape_entries(torch, flash, decode, shapes, "[lm]")
    # the decode route's GQA repeat: one layer's K (or V) cache, [b, kvh,
    # cache, d], copied to [b, h, cache, d] before the kernel reads it
    small = torch.randn(b, kvh, s + gen, d, device=LM_DEVICE).to(
        torch.bfloat16)
    repeat_ms = _time_ms(torch, lambda: layers._repeat_kv(small, h // kvh),
                         20)
    del small
    torch.cuda.empty_cache()
    return entries, rows, repeat_ms


def _device_busy(torch, fn, top: int = 6) -> tuple[float, list]:
    """Run `fn` once under torch.profiler: the summed device time of its
    kernels, copies and sets (ms; one stream, so they do not overlap) and
    the `top` device ops by time, [name, ms]."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    dev.sort(key=lambda e: -e.self_device_time_total)
    return (sum(e.self_device_time_total for e in dev) / 1e3,
            [[e.key[:70], e.self_device_time_total / 1e3] for e in dev[:top]])


@contextlib.contextmanager
def _no_sync(torch):
    """Raise on any operation that waits for the card (a value read back,
    a copy from pageable host memory) inside the block."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


@contextlib.contextmanager
def _per_call_rope_copy(torch, layers):
    """RoPE's table copied from host memory at every call, the fault the
    no-sync check guards against (`layers._rope_freqs_on` keeps it on the
    card)."""
    orig = layers._rope_freqs_on
    layers._rope_freqs_on = lambda head_dim, theta, device: torch.as_tensor(
        layers.rope_freqs(head_dim, theta).astype(np.float32), device=device)
    try:
        yield
    finally:
        layers._rope_freqs_on = orig


def lm_breakdown(torch, lm, layers, cfg) -> dict:
    """Where a warm prefill and a warm decode step of the full-width run go:
    their wall (host clock, ending in a synchronise; the decode step the
    median of LM_STEPS_TIMED), the device's busy time under torch.profiler
    and its idle share (1 - busy / wall), the aten ops each dispatches, and
    the top device ops. A warm
    prefill and decode step first run once with every synchronising
    operation made an error: neither waits for the card (and a step
    that copies RoPE's table from the host at every call is shown to
    fail it)."""
    from repro_torch.analysis.dispatch import record as record_ops

    b, s = LM_SERVE["batch"], LM_SERVE["prompt_len"]
    params = lm.init_params(
        cfg, torch.Generator(device=LM_DEVICE).manual_seed(0), LM_DEVICE)
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (b, s)), dtype=torch.int32,
        device=LM_DEVICE)}
    max_len = s + LM_SERVE["gen"]
    out = {}
    with torch.inference_mode():
        run_prefill = lambda: lm.prefill(  # noqa: E731
            cfg, params, batch, max_len=max_len)
        run_prefill()
        torch.cuda.synchronize()
        with _no_sync(torch):
            run_prefill()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = run_prefill()
        torch.cuda.synchronize()
        walls = {"prefill": time.perf_counter() - t0}
        tokens = torch.argmax(logits, -1)[:, None].to(torch.int32)
        idx = torch.full((), s, dtype=torch.int32, device=LM_DEVICE)
        step = lambda: lm.decode_step(  # noqa: E731
            cfg, params, tokens, caches, idx)
        step()
        torch.cuda.synchronize()
        with _no_sync(torch):
            step()
        torch.cuda.synchronize()
        try:
            with _per_call_rope_copy(torch, layers), _no_sync(torch):
                step()
        except RuntimeError as exc:
            say(f"[lm] the no-sync check rejects a per-call host copy: "
                f"{str(exc).splitlines()[0][:100]}")
        else:
            raise AssertionError("the no-sync check passes a decode step "
                                 "that copies from the host every call")
        torch.cuda.synchronize()
        times = []
        for _ in range(LM_STEPS_TIMED):
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        walls["decode_step"] = float(np.median(times))
        for name, fn in (("prefill", run_prefill), ("decode_step", step)):
            busy_ms, top = _device_busy(torch, fn)
            # the host's work: the aten ops the call dispatches
            n_ops = sum(not op.name.startswith("kernel:")
                        for op in record_ops(fn))
            out[name] = {"wall_ms": walls[name] * 1e3, "busy_ms": busy_ms,
                         "idle_share": 1 - busy_ms / (walls[name] * 1e3),
                         "aten_ops": n_ops, "top": top}
            say(f"[lm] warm {name}: wall {walls[name] * 1e3:.3f} ms, device "
                f"busy {busy_ms:.3f} ms, idle share "
                f"{out[name]['idle_share']:.3f}, {n_ops} aten ops "
                f"({walls[name] * 1e6 / n_ops:.2f} us of wall each); top "
                "device ops (ms): "
                + "; ".join(f"{n} {ms:.3f}" for n, ms in top))
    del params, caches, logits
    torch.cuda.empty_cache()
    return out

def phase_lm(torch, flash, decode, smi) -> tuple[list, dict]:
    """Phase 14: the LM serving path (models/, launch/serve.py) at full
    width, its launches and routes, kernel route == plain route, and
    prefill-then-decode at the cut. Returns (the kernels line's entries,
    results)."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import serve as lm_serve
    from repro_torch.models import layers, lm

    t_phase = time.perf_counter()
    cfg = get_config(LM_ARCH)
    b, s, gen = LM_SERVE["batch"], LM_SERVE["prompt_len"], LM_SERVE["gen"]
    n_layers, h, d = cfg.num_layers, cfg.num_heads, cfg.resolved_head_dim
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    flash.LAUNCHES.clear()
    decode.LAUNCHES.clear()
    layers.ROUTES.clear()
    t0 = time.perf_counter()
    seqs, t_prefill, t_decode = lm_serve.serve(
        LM_ARCH, smoke=False, device=LM_DEVICE, **LM_SERVE)
    wall = time.perf_counter() - t0
    launches = {"flash": dict(flash.LAUNCHES),
                "decode": dict(decode.LAUNCHES)}
    routes = dict(layers.ROUTES)
    peak = torch.cuda.max_memory_allocated()
    flash_key = (b * h, s, s, d, "bfloat16", True, 0)
    decode_key = (b * h, s + gen, d, "bfloat16")
    assert launches["flash"] == {flash_key: n_layers}, launches
    assert launches["decode"] == {decode_key: n_layers * (gen - 1)}, launches
    assert routes == {"flash": n_layers, "decode": n_layers * (gen - 1)}, \
        f"routes {routes}: the plain route was taken"
    seqs = seqs.cpu()
    assert seqs.shape == (b, gen), seqs.shape
    assert int(seqs.min()) >= 0 and int(seqs.max()) < cfg.vocab_size
    per_tok_ms = t_decode / (gen - 1) / b * 1e3
    results = {
        "arch": LM_ARCH, "params": cfg.param_count(), **LM_SERVE,
        "prefill_s": t_prefill, "decode_s": t_decode,
        "decode_ms_per_token_per_seq": per_tok_ms,
        "decode_step_ms": t_decode / (gen - 1) * 1e3,
        "decode_tokens_per_s": b * (gen - 1) / t_decode,
        "prefill_tokens_per_s": b * s / t_prefill,
        "serve_wall_s": wall, "peak_bytes": peak,
        "launches": {k: {str(kk): n for kk, n in v.items()}
                     for k, v in launches.items()},
        "routes": routes, "sample": seqs[0, :16].tolist(), "card": smi}
    say(f"[lm] {LM_ARCH} full width ({cfg.param_count():,} parameters, "
        f"{n_layers} layers, bf16): batch {b}, prompt {s}, {gen} tokens; "
        f"prefill {t_prefill:.4f}s ({results['prefill_tokens_per_s']:.0f} "
        f"tokens/s), decode {t_decode:.4f}s ({per_tok_ms:.4f} ms/token/seq, "
        f"{results['decode_tokens_per_s']:.1f} tokens/s, step "
        f"{results['decode_step_ms']:.3f} ms); serve() {wall:.1f}s; peak "
        f"{peak / 2**30:.2f} GiB; {smi}")
    say(f"[lm] launches: flash {launches['flash']}, decode "
        f"{launches['decode']}; routes {routes}")
    entries, rows, repeat_ms = lm_kernel_entries(torch, flash, decode,
                                                 layers, cfg, launches)
    flash_ms, decode_ms = (next(e["ms"] for e in entries
                                if e["name"].startswith(kernel))
                           for kernel in ("flash", "decode"))
    results.update({
        "kernels": rows, "gqa_repeat_ms": repeat_ms,
        "prefill_flash_share": n_layers * flash_ms / 1e3 / t_prefill,
        "decode_kernel_share": n_layers * decode_ms / results[
            "decode_step_ms"],
        "decode_repeat_share": 2 * n_layers * repeat_ms / results[
            "decode_step_ms"]})
    say(f"[lm] prefill: {n_layers} flash calls {n_layers * flash_ms:.2f} ms "
        f"({100 * results['prefill_flash_share']:.1f}% of prefill); decode "
        f"step {results['decode_step_ms']:.3f} ms: {n_layers} decode "
        f"kernels {n_layers * decode_ms:.3f} ms "
        f"({100 * results['decode_kernel_share']:.1f}%), the GQA repeat of "
        f"K and V {2 * n_layers} x {repeat_ms:.4f} ms "
        f"({100 * results['decode_repeat_share']:.1f}%)")
    results["breakdown"] = lm_breakdown(torch, lm, layers, cfg)
    results["cut"] = lm_kernel_vs_plain(torch, lm, layers, cfg)
    results["phase_seconds"] = time.perf_counter() - t_phase
    say(f"[lm] phase 14 {results['phase_seconds']:.1f}s")
    return entries, results

# --------------------------------------------------------------- phase 15
# the LM families beyond dense, at full width through
# `repro_torch.launch.serve.serve` (src/repro/configs/: qwen2_vl_2b,
# whisper_tiny, deepseek_moe_16b, phi35_moe, mamba2_370m, hymba_15b,
# h2o_danube_18b), random weights from seed 0: batch 4, a 2048-token
# prompt (whisper's decoder 448, its real context, against its 1536
# encoder frames; hymba's equals its window, so the decode steps wrap the
# ring; h2o-danube's 8192, two windows of 4096: prefill takes the flash
# kernel's band at head dim 80, and decode reads its 4096-slot ring),
# 16 tokens
LM_FAMILY_ARCHS = ("qwen2-vl-2b", "whisper-tiny", "deepseek-moe-16b",
                   "phi3.5-moe-42b-a6.6b", "mamba2-370m", "hymba-1.5b",
                   "h2o-danube-1.8b")
LM_FAMILY_SERVE = {"batch": 4, "prompt_len": 2048, "gen": 16}
LM_FAMILY_PROMPT = {"whisper-tiny": 448, "h2o-danube-1.8b": 8192}
# hymba past its window: a full-width prefill (32 layers, batch 4) of
# 4096 tokens, twice its window of 2048, its 29 windowed layers on the
# flash kernel's band; and its kernel-vs-plain cut at that prompt
LM_PAST_WINDOW_ARCH = "hymba-1.5b"
LM_PAST_WINDOW = {"batch": 4, "prompt_len": 4096}
# phi3.5-moe's 4.19e10 parameters are 83.8 GB in bf16, past one 80 GB
# card: its depth is cut to 4 of 32 layers, its widths kept
LM_FAMILY_DEPTH = {"phi3.5-moe-42b-a6.6b": 4}
# kernel route against plain route and prefill-then-decode: the full widths
# with the depth cut to 2 layers (whisper's encoder too; hymba 5: its 3
# global layers and 2 windowed), batch 2, 4 teacher-forced decode steps,
# a 1024-token prompt (whisper 448; hymba 2048, its window, so the decode
# steps write the ring's wrapped slots; h2o-danube 4608, past its window
# of 4096: the band is live in prefill and the ring wraps)
LM_FAMILY_CUT = {"num_layers": 2, "batch": 2, "prompt_len": 1024,
                 "steps": 4}
LM_FAMILY_CUT_PROMPT = {"whisper-tiny": 448, "hymba-1.5b": 2048,
                        "h2o-danube-1.8b": 4608}
LM_FAMILY_CUT_LAYERS = {"hymba-1.5b": 5}
# at the cut, the fp32 kernel route's mean logit error against the plain
# fp32 route at most this share of N, the mean error bf16 rounding alone
# gives the same model (plain bf16 against plain fp32): the reference's
# init puts attention near an argmax (fan_in = L), so a near-tie can flip
# a token in either fp32 route, and the logits are not held elementwise
LM_FAMILY_F32_SHARE = 0.25
# an attention call's mean error against its float64 truth may pass twice
# the plain route's by this share of the truth's mean magnitude (fp32 128
# ulps, bf16 one ulp at 1)
LM_FAMILY_CALL_FLOOR = {"float32": 2 ** -16, "bfloat16": 2 ** -8}


def layer_windows(cfg) -> dict:
    """{window: decoder layers}: the band each self-attention layer passes
    (hymba's global layers 0, its others and every h2o-danube layer the
    sliding window; 0 elsewhere)."""
    windowed = cfg.num_layers if cfg.sliding_window else 0
    if cfg.hybrid:
        windowed = cfg.num_layers - cfg.num_global_layers
    return {w: n for w, n in ((cfg.sliding_window, windowed),
                              (0, cfg.num_layers - windowed)) if n}


def family_launches(cfg, b: int, s: int, steps: int, max_len: int):
    """The flash and decode launches, by the kernels' keys, of a prefill of
    `s` tokens (plus the VLM's 8 patches) and `steps` decode steps into
    caches of `max_len` slots, at bf16: a causal flash call per decoder
    layer (with its band, `layer_windows`); whisper's encoder layers and
    cross-attention in full mode; a decode call per layer and step (a
    windowed layer's against its window's ring), whisper's
    cross-attention against its frames."""
    flash, decode = {}, {}

    def add(table, key, n):
        if n:
            table[key] = table.get(key, 0) + n

    if not cfg.num_heads:
        return flash, decode
    bh, d, dt = b * cfg.num_heads, cfg.resolved_head_dim, "bfloat16"
    if cfg.dtype != "bfloat16":
        dt = "float32"
    sq = s + (min(cfg.num_patches, 8) if cfg.family == "vlm" else 0)
    for w, n in layer_windows(cfg).items():
        add(flash, (bh, sq, sq, d, dt, True, w), n)
    windowed = layer_windows(cfg).get(cfg.sliding_window, 0) \
        if cfg.sliding_window else 0
    if cfg.sliding_window:
        add(decode, (bh, min(cfg.sliding_window, max_len), d, dt),
            windowed * steps)
    add(decode, (bh, max_len, d, dt), (cfg.num_layers - windowed) * steps)
    if cfg.encoder_decoder:
        se = cfg.encoder_seq
        add(flash, (bh, se, se, d, dt, False, 0), cfg.encoder_layers)
        add(flash, (bh, sq, se, d, dt, False, 0), cfg.num_layers)
        add(decode, (bh, se, d, dt), cfg.num_layers * steps)
    return flash, decode


@contextlib.contextmanager
def _depth_cut(lm_serve, arch: str, n_layers):
    """`serve` loads `arch` with its depth cut to `n_layers` (None: as
    published), its widths kept."""
    orig = lm_serve.get_config
    if n_layers:
        lm_serve.get_config = lambda a: dataclasses.replace(
            orig(a), num_layers=n_layers) if a == arch else orig(a)
    try:
        yield
    finally:
        lm_serve.get_config = orig


def _mean_err(a, b) -> float:
    return float((a.float() - b.float()).abs().mean())


def family_step(torch, lm, lm_serve, cfg, b, s, gen) -> dict:
    """A warm decode step of the full-width serve, on weights and prompts
    made as `serve` makes them: run once with every synchronising
    operation an error (`_no_sync`), then its wall (the median of
    LM_STEPS_TIMED, host clock ending in a synchronise), device
    busy time (torch.profiler), idle share, aten ops and top device ops."""
    from repro_torch.analysis.dispatch import record as record_ops

    params = lm.init_params(
        cfg, torch.Generator(device=LM_DEVICE).manual_seed(0), LM_DEVICE)
    batch, sq = lm_serve.serve_inputs(cfg, np.random.default_rng(0), b, s,
                                      LM_DEVICE)
    logits, caches = lm.prefill(cfg, params, batch, max_len=s + gen)
    tokens = torch.argmax(logits, -1)[:, None].to(torch.int32)
    idx = torch.full((), sq, dtype=torch.int32, device=LM_DEVICE)
    vlm = cfg.family == "vlm"
    step = lambda: lm.decode_step(  # noqa: E731
        cfg, params, tokens, caches, idx,
        pos3=idx.reshape(1, 1, 1).expand(3, b, 1) if vlm else None)
    step()
    torch.cuda.synchronize()
    with _no_sync(torch):
        step()
    torch.cuda.synchronize()
    times = []
    for _ in range(LM_STEPS_TIMED):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    wall_ms = float(np.median(times)) * 1e3
    busy_ms, top = _device_busy(torch, step)
    n_ops = sum(not op.name.startswith("kernel:") for op in record_ops(step))
    del params, caches, logits, batch
    torch.cuda.empty_cache()
    return {"wall_ms": wall_ms, "busy_ms": busy_ms,
            "idle_share": 1 - busy_ms / wall_ms, "aten_ops": n_ops,
            "top": top}


def family_serve(torch, flash, decode, layers, lm, lm_serve, arch,
                 smi) -> tuple[dict, dict]:
    """One arch through `serve.serve(smoke=False)` with the routes and the
    launch counters set to 0 before and read after: the launches asserted
    (`family_launches`; no plain route), the tokens
    checked, and the warm decode step (`family_step`). Returns (results,
    the launches by kernel key)."""
    from repro_torch.configs.base import get_config

    b, gen = LM_FAMILY_SERVE["batch"], LM_FAMILY_SERVE["gen"]
    s = LM_FAMILY_PROMPT.get(arch, LM_FAMILY_SERVE["prompt_len"])
    cfg = get_config(arch)
    if arch in LM_FAMILY_DEPTH:
        cfg = dataclasses.replace(cfg, num_layers=LM_FAMILY_DEPTH[arch])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    flash.LAUNCHES.clear()
    decode.LAUNCHES.clear()
    layers.ROUTES.clear()
    with _depth_cut(lm_serve, arch, LM_FAMILY_DEPTH.get(arch)):
        t0 = time.perf_counter()
        seqs, t_prefill, t_decode = lm_serve.serve(
            arch, smoke=False, device=LM_DEVICE, batch=b, prompt_len=s,
            gen=gen)
        wall = time.perf_counter() - t0
    launches = {"flash": dict(flash.LAUNCHES),
                "decode": dict(decode.LAUNCHES)}
    routes = dict(layers.ROUTES)
    peak = torch.cuda.max_memory_allocated()
    want_flash, want_decode = family_launches(cfg, b, s, gen - 1, s + gen)
    assert launches == {"flash": want_flash, "decode": want_decode}, (
        arch, launches, want_flash, want_decode)
    n_flash, n_decode = sum(want_flash.values()), sum(want_decode.values())
    want_routes = {k: n for k, n in (("flash", n_flash),
                                     ("decode", n_decode)) if n}
    assert routes == want_routes, f"{arch}: routes {routes}, plain taken?"
    seqs = seqs.cpu()
    assert seqs.shape == (b, gen), seqs.shape
    assert int(seqs.min()) >= 0 and int(seqs.max()) < cfg.vocab_size
    res = {"arch": arch, "params": cfg.param_count(),
           "num_layers": cfg.num_layers, "batch": b, "prompt_len": s,
           "gen": gen, "prefill_s": t_prefill, "decode_s": t_decode,
           "decode_step_ms": t_decode / (gen - 1) * 1e3,
           "decode_ms_per_token_per_seq": t_decode / (gen - 1) / b * 1e3,
           "decode_tokens_per_s": b * (gen - 1) / t_decode,
           "prefill_tokens_per_s": b * s / t_prefill,
           "serve_wall_s": wall, "peak_bytes": peak,
           "launches": {k: {str(kk): n for kk, n in v.items()}
                        for k, v in launches.items()},
           "routes": routes, "sample": seqs[0, :16].tolist(), "card": smi}
    say(f"[lm families] {arch} ({cfg.param_count():,} parameters, "
        f"{cfg.num_layers} layers, bf16): batch {b}, prompt {s}, {gen} "
        f"tokens; prefill {t_prefill:.4f}s "
        f"({res['prefill_tokens_per_s']:.0f} tokens/s), decode step "
        f"{res['decode_step_ms']:.3f} ms ({res['decode_tokens_per_s']:.1f}"
        f" tokens/s); serve() {wall:.1f}s; peak {peak / 2**30:.2f} GiB; "
        f"routes {routes}; {smi}")
    res["step"] = family_step(torch, lm, lm_serve, cfg, b, s, gen)
    st = res["step"]
    say(f"[lm families] {arch} warm decode step (no sync): wall "
        f"{st['wall_ms']:.3f} ms, device busy {st['busy_ms']:.3f} ms, idle "
        f"share {st['idle_share']:.3f}, {st['aten_ops']} aten ops; top "
        "device ops (ms): "
        + "; ".join(f"{n} {ms:.3f}" for n, ms in st["top"]))
    return res, launches


def lm_shape_entries(torch, flash, decode, shapes, tag) -> tuple:
    """The kernels line's entries for every (kernel, shape) an LM serve
    launched, each against its plain version on inputs of that shape (K/V
    drawn with the arch's KV heads and repeated), two launches bitwise
    equal, with kernel / plain / SDPA / bound ms. `shapes`: {(kernel,
    key): {"launches_by_run": {arch: n}, "b", "h", "kvh", "valid" (the
    decode calls' last valid_len)}}. Returns (entries, rows)."""
    F = torch.nn.functional
    entries, rows = [], []
    for (kernel, key), info in sorted(shapes.items(), key=str):
        b, h, kvh = info["b"], info["h"], info["kvh"]
        extra = {}
        launches = sum(info["launches_by_run"].values())
        if kernel == "flash":
            bh, sq, skv, d, dtype, causal, w = key
            q, k, v = _attn_inputs(torch, (b, h, sq, d), (b, h, skv, d),
                                   torch.bfloat16, sq + skv, kv_heads=kvh)
            fold = lambda x: x.reshape(bh, x.shape[2], d)  # noqa: E731
            qf, kf, vf = fold(q), fold(k), fold(v)
            out = flash.flash_attention(qf, kf, vf, causal=causal, window=w)
            assert torch.equal(out, flash.flash_attention(
                qf, kf, vf, causal=causal, window=w)), \
                f"flash {key}: repeat differs"
            plain_fwd = lambda: _by_heads(  # noqa: E731
                torch, flash.flash_attention_plain, (qf, kf, vf), sq, skv,
                causal=causal, window=w)
            plain = plain_fwd()
            err, rel, tol = _hold_attn(torch, f"{tag} flash {key}", out,
                                       plain, dtype,
                                       min(w, skv) if w else skv)
            ms = _time_ms(torch, lambda: flash.flash_attention(
                qf, kf, vf, causal=causal, window=w), 10)
            plain_ms = _time_ms(torch, plain_fwd, 3)
            call = _sdpa_call(torch, q, k, v, causal, w)
            library_ms = _library(torch, _time_ms, call, 10)
            bound_ms, bound_by = _attn_bound(dtype, bh, sq, skv, d,
                                             causal=causal, window=w)
            name = _flash_name("flash_attention", key)
            entry = _attn_entry(name, "flash_attention.cu",
                                "src/repro/kernels/flash_attention.py:32",
                                launches, err, ms, plain_ms, bound_ms,
                                bound_by, library_ms)
            if w and w < sq:  # the backend SDPA's band mask took
                extra["library_kernels"] = _library(torch, _sdpa_kernels,
                                                    call)
            del q, k, v, qf, kf, vf, out, plain, call
        else:
            bh, s, d, dtype = key
            valid = info["valid"]
            q, k, v = _attn_inputs(torch, (b, h, d), (b, h, s, d),
                                   torch.bfloat16, s + d, kv_heads=kvh)
            qf, kf, vf = q.reshape(bh, d), k.reshape(bh, s, d), \
                v.reshape(bh, s, d)
            valid_t = torch.tensor(valid, dtype=torch.int32, device="cuda")
            out = decode.decode_attention(qf, kf, vf, valid_t)
            assert torch.equal(out, decode.decode_attention(
                qf, kf, vf, valid_t)), f"decode {key}: repeat differs"
            plain = decode.decode_attention_plain(qf, kf, vf, valid)
            err, rel, tol = _hold_attn(torch, f"{tag} decode {key}", out,
                                       plain, dtype, valid)
            ms = _time_ms(torch, lambda: decode.decode_attention(
                qf, kf, vf, valid_t), 20)
            plain_ms = _time_ms(torch, lambda: decode.decode_attention_plain(
                qf, kf, vf, valid_t), 5)
            q4, ks, vs = q[:, :, None], k[:, :, :valid], v[:, :, :valid]
            library_ms = _time_ms(
                torch, lambda: F.scaled_dot_product_attention(q4, ks, vs), 20)
            bound_ms, bound_by = _attn_bound(dtype, bh, 1, s, d, valid=valid)
            name = (f"decode_attention[{dtype},BH={bh},S={s},valid={valid},"
                    f"D={d}]")
            entry = _attn_entry(name, "decode_attention.cu",
                                "src/repro/kernels/decode_attention.py:26",
                                launches, err, ms, plain_ms, bound_ms,
                                bound_by, library_ms)
            del q, k, v, qf, kf, vf, out, plain, q4, ks, vs
        entry["launches_by_run"] = dict(info["launches_by_run"])
        entries.append(entry)
        rows.append(dict(entry, tol=tol, row_rel_err=rel, **extra))
        say(f"{tag} {name}: launches {entry['launches_by_run']}, "
            f"err {err:.3g}, ms {ms:.4f} plain {plain_ms:.4f} sdpa "
            f"{library_ms} bound {bound_ms:.4f} ({bound_by})"
            + (f"; sdpa's band kernels {extra['library_kernels']}"
               if extra else ""))
        torch.cuda.empty_cache()
    return entries, rows


def _to_dtype(torch, tree, dtype):
    """A parameter tree with its bf16 leaves cast to `dtype` (the fp32
    leaves, norms and the router, stay as they are)."""
    if isinstance(tree, dict):
        return {k: _to_dtype(torch, v, dtype) for k, v in tree.items()}
    return tree.to(dtype) if tree.dtype == torch.bfloat16 else tree


def family_cut_run(torch, lm, cfg, params, batch, s, steps, use_pallas):
    """Prefill over `s` prompt tokens of `batch` (serve_inputs' batch over
    s + steps tokens, the VLM's patch prefix and M-RoPE positions
    included), then `steps` teacher-forced decode steps: the logits
    stacked [steps + 1, B, V]."""
    tokens = batch["tokens"]
    b = tokens.shape[0]
    prefix = batch["patch_embeds"].shape[1] if "patch_embeds" in batch else 0
    prompt = dict(batch, tokens=tokens[:, :s])
    if "pos3" in batch:
        prompt["pos3"] = batch["pos3"][..., :prefix + s]
    with torch.inference_mode():
        logits, caches = lm.prefill(cfg, params, prompt,
                                    max_len=prefix + s + steps,
                                    use_pallas=use_pallas)
        outs = [logits]
        for t in range(steps):
            idx = prefix + s + t
            pos3 = (torch.full((3, b, 1), idx, dtype=torch.int32,
                               device=tokens.device)
                    if "pos3" in batch else None)
            logits, caches = lm.decode_step(
                cfg, params, tokens[:, s + t:s + t + 1], caches, idx,
                pos3=pos3, use_pallas=use_pallas)
            outs.append(logits)
    return torch.stack(outs)


@contextlib.contextmanager
def _checked_attention(torch, layers, calls):
    """Every `layers.attention` call returns its route's output as before,
    and is also computed on the plain route at its dtype and, as the
    truth, on the plain route in float64 from the same inputs; each call's
    route, shapes and mean errors against the truth go to `calls`. The
    routes of the extra calls are taken out of `layers.ROUTES` again."""
    orig = layers.attention

    def checked(q, k, v, **kw):
        before = dict(layers.ROUTES)
        out = orig(q, k, v, **kw)
        route = next(r for r, n in layers.ROUTES.items()
                     if n != before.get(r, 0))
        plain_kw = dict(kw, use_pallas=False)
        plain = orig(q, k, v, **plain_kw)
        truth = orig(q.double(), k.double(), v.double(), **plain_kw)
        layers.ROUTES["plain"] -= 2
        if not layers.ROUTES["plain"]:
            del layers.ROUTES["plain"]
        calls.append({
            "route": route, "q": tuple(q.shape), "kv": tuple(k.shape),
            "causal": kw.get("causal", True),
            "err": float((out.double() - truth).abs().mean()),
            "plain_err": float((plain.double() - truth).abs().mean()),
            "scale": float(truth.abs().mean())})
        return out

    layers.attention = checked
    try:
        yield
    finally:
        layers.attention = orig


def _hold_calls(dtype, calls, what, fails) -> dict:
    """Every checked attention call (`_checked_attention`): its mean error
    against the float64 truth at most twice the plain route's, plus
    LM_FAMILY_CALL_FLOOR of the truth's mean magnitude; the rule shown to
    reject a zeroed output (mean error = the truth's mean magnitude) at
    every call. Returns the worst ratio of error to bound by route."""
    worst = {}
    for c in calls:
        bound = (2 * c["plain_err"]
                 + LM_FAMILY_CALL_FLOOR[dtype] * c["scale"])
        if not c["err"] <= bound:
            fails.append(f"{what} {dtype} attention call {c['route']} q "
                         f"{c['q']} kv {c['kv']}: mean err {c['err']:.3g} >"
                         f" {bound:.3g}")
        if not c["scale"] > bound:
            fails.append(f"{what} {dtype} attention call {c['route']}: a "
                         "zeroed output passes")
        worst[c["route"]] = max(worst.get(c["route"], 0.0), c["err"] / bound)
    return worst


def family_cut(torch, lm, lm_serve, layers, arch, fails,
               prompt=None) -> dict:
    """At the full widths cut to LM_FAMILY_CUT depth, bf16 and the same
    weights cast to fp32, `family_cut_run` on the kernel route twice
    (bitwise equal; the first with the routes counted as
    `family_launches` counts, the second with every attention call checked
    against a float64 plain evaluation of its own inputs,
    `_checked_attention` / `_hold_calls`), on the plain route and with
    every attention output zeroed. The logits, by mean error over the
    steps (the reference's init puts attention near an argmax, so a token
    can flip on a near-tie in either route; N = the plain bf16 run's mean
    error against the plain fp32 run, bf16's own rounding of the model):
    bf16 kernel against plain fp32 at most 2 N + 2^-8; fp32 kernel
    against plain fp32 at most LM_FAMILY_F32_SHARE x N, shown to reject
    the zeroed run (bf16: reported). Prefill-then-decode on the kernel
    route (the MoE family exempt, as in the reference): decoding token s
    after a prefill of s against a prefill of s + 1, by mean error, fp32
    at most LM_FAMILY_F32_SHARE x N, bf16 at most 2 N + 2^-8. A failed
    check goes to `fails`. `prompt` overrides LM_FAMILY_CUT_PROMPT."""
    from repro_torch.configs.base import get_config

    b, steps = LM_FAMILY_CUT["batch"], LM_FAMILY_CUT["steps"]
    s = prompt or LM_FAMILY_CUT_PROMPT.get(arch, LM_FAMILY_CUT["prompt_len"])
    n = LM_FAMILY_CUT_LAYERS.get(arch, LM_FAMILY_CUT["num_layers"])
    cfg = dataclasses.replace(get_config(arch), num_layers=n)
    if cfg.encoder_decoder:
        cfg = dataclasses.replace(cfg, encoder_layers=n)
    batch, total = lm_serve.serve_inputs(cfg, np.random.default_rng(1), b,
                                         s + steps, LM_DEVICE)
    prefix = total - s - steps
    p16 = lm.init_params(
        cfg, torch.Generator(device=LM_DEVICE).manual_seed(1), LM_DEVICE)
    attn = bool(cfg.num_heads)
    runs, calls = {}, {}
    out = {"num_layers": n, "prompt_len": s}
    for dtype in ("bfloat16", "float32"):
        c = dataclasses.replace(cfg, dtype=dtype)
        params = p16 if dtype == "bfloat16" else _to_dtype(
            torch, p16, torch.float32)
        bt = batch if dtype == "bfloat16" else {
            k: (v.float() if v.dtype == torch.bfloat16 else v)
            for k, v in batch.items()}
        run = lambda use_pallas: family_cut_run(  # noqa: E731
            torch, lm, c, params, bt, s, steps, use_pallas)
        layers.ROUTES.clear()
        runs[dtype, "kernel"] = run(None)
        routes = dict(layers.ROUTES)
        flash_n, decode_n = family_launches(c, b, s, steps,
                                            prefix + s + steps)
        want = {k: v for k, v in (("flash", sum(flash_n.values())),
                                  ("decode", sum(decode_n.values()))) if v}
        if routes != want:
            fails.append(f"{arch} {dtype} cut routes {routes} != {want}")
        calls[dtype] = []
        with _checked_attention(torch, layers, calls[dtype]):
            checked = run(None)
        # the repeat: the checked run returns the kernel route's outputs
        if not torch.equal(runs[dtype, "kernel"], checked):
            fails.append(f"{arch} {dtype}: kernel runs differ")
        if len(calls[dtype]) != sum(want.values()):
            fails.append(f"{arch} {dtype}: {len(calls[dtype])} attention "
                         f"calls checked, {sum(want.values())} made")
        out[f"calls_{dtype}"] = _hold_calls(dtype, calls[dtype], arch, fails)
        runs[dtype, "plain"] = run(False)
        with _zeroed_attention(layers):
            runs[dtype, "zeroed"] = run(None)
        # prefill-then-decode on the kernel route (MoE exempt)
        if cfg.family != "moe":
            one = dict(bt, tokens=bt["tokens"][:, :s + 1])
            if "pos3" in bt:
                one["pos3"] = bt["pos3"][..., :prefix + s + 1]
            runs[dtype, "decoded"] = family_cut_run(
                torch, lm, c, params, one, s, 1, None)[1]
            with torch.inference_mode():
                runs[dtype, "full"], _ = lm.prefill(
                    c, params, one, max_len=prefix + s + 8)
        del params, checked
        torch.cuda.empty_cache()
    truth = runs["float32", "plain"]
    noise = _mean_err(runs["bfloat16", "plain"], truth)
    bounds = {"bfloat16": 2 * noise + 2 ** -8,
              "float32": LM_FAMILY_F32_SHARE * noise}
    out.update(bf16_noise=noise, logit_max=float(truth.abs().max()))
    for dtype, bound in bounds.items():
        err = _mean_err(runs[dtype, "kernel"], truth)
        zero = _mean_err(runs[dtype, "zeroed"], truth)
        out[f"{dtype}_mean_err"], out[f"{dtype}_zeroed_mean_err"] = err, zero
        out[f"{dtype}_max_abs_err"] = _max_abs_err(
            torch, runs[dtype, "kernel"], runs[dtype, "plain"])
        out[f"{dtype}_bound"] = bound
        if not err <= bound:
            fails.append(f"{arch} {dtype} kernel route: mean err {err:.4g} "
                         f"> {bound:.4g}")
        out[f"{dtype}_zeroed_rejected"] = zero > bound
        if attn and dtype == "float32" and not zero > bound:
            fails.append(f"{arch} fp32: a zeroed attention output passes")
        if not attn and not torch.equal(runs[dtype, "kernel"],
                                        runs[dtype, "plain"]):
            fails.append(f"{arch} {dtype}: no attention, yet the routes "
                         "differ")
        if cfg.family != "moe":
            dec, full = runs[dtype, "decoded"], runs[dtype, "full"]
            cons = _mean_err(dec, full)
            out[f"{dtype}_consistency_mean_err"] = cons
            out[f"{dtype}_consistency_max_abs_err"] = _max_abs_err(
                torch, dec, full)
            if not cons <= bound:
                fails.append(f"{arch} {dtype} prefill-then-decode: mean err "
                             f"{cons:.4g} > {bound:.4g}")
    say(f"[lm families] {arch} kernel vs plain ({n} layers, batch {b}, "
        f"prompt {s}, {steps} decode steps; largest |logit| "
        f"{out['logit_max']:.3g}, bf16 noise N {noise:.4g}): "
        + "; ".join(
            f"{dt} mean err {out[f'{dt}_mean_err']:.4g} (bound "
            f"{out[f'{dt}_bound']:.4g}, max |kernel - plain| "
            f"{out[f'{dt}_max_abs_err']:.3g}), zeroed "
            f"{out[f'{dt}_zeroed_mean_err']:.3g} "
            f"{'rejected' if out[f'{dt}_zeroed_rejected'] else 'passes'}"
            + (f", prefill-then-decode mean "
               f"{out[f'{dt}_consistency_mean_err']:.3g} max "
               f"{out[f'{dt}_consistency_max_abs_err']:.3g}"
               if cfg.family != "moe" else "")
            for dt in ("float32", "bfloat16"))
        + ("; attention calls (worst error / bound by route) "
           + ", ".join(f"{dt} {len(calls[dt])} {out[f'calls_{dt}']}"
                       for dt in ("float32", "bfloat16"))
           if attn else "; no attention"))
    del runs, p16, batch
    torch.cuda.empty_cache()
    return out


def past_window_prefill(torch, flash, layers, lm, lm_serve) -> tuple:
    """LM_PAST_WINDOW_ARCH's full-width prefill of LM_PAST_WINDOW's prompt,
    past its window, on seed 0's weights and `serve_inputs`' prompt, the
    routes and flash launches counted from 0: every layer on the flash
    route (`family_launches`, the windowed layers with their band), no
    plain, finite logits. Returns (results, the flash launches)."""
    from repro_torch.configs.base import get_config

    arch = LM_PAST_WINDOW_ARCH
    b, s = LM_PAST_WINDOW["batch"], LM_PAST_WINDOW["prompt_len"]
    cfg = get_config(arch)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = lm.init_params(
        cfg, torch.Generator(device=LM_DEVICE).manual_seed(0), LM_DEVICE)
    batch, sq = lm_serve.serve_inputs(cfg, np.random.default_rng(0), b, s,
                                      LM_DEVICE)
    flash.LAUNCHES.clear()
    layers.ROUTES.clear()
    walls = []
    for _ in range(2):  # cold, then warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            logits, caches = lm.prefill(cfg, params, batch, max_len=sq)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if not walls[1:]:
            launches, routes = dict(flash.LAUNCHES), dict(layers.ROUTES)
    peak = torch.cuda.max_memory_allocated()
    want, _ = family_launches(cfg, b, s, 0, sq)
    assert launches == want, (arch, launches, want)
    assert routes == {"flash": cfg.num_layers}, f"{arch}: routes {routes}"
    assert logits.shape == (b, cfg.vocab_size), logits.shape
    assert bool(torch.isfinite(logits.float()).all()), f"{arch}: not finite"
    res = {"arch": arch, "batch": b, "prompt_len": s,
           "window": cfg.sliding_window, "num_layers": cfg.num_layers,
           "prefill_s": walls, "prefill_tokens_per_s": b * s / walls[1],
           "peak_bytes": peak, "routes": routes,
           "launches": {str(k): n for k, n in launches.items()}}
    say(f"[lm families] {arch} past its window: prefill of {s} tokens "
        f"(window {cfg.sliding_window}), batch {b}, {cfg.num_layers} layers"
        f": cold {walls[0]:.4f}s, warm {walls[1]:.4f}s "
        f"({res['prefill_tokens_per_s']:.0f} tokens/s); peak "
        f"{peak / 2**30:.2f} GiB; routes {routes}; flash launches "
        f"{launches}")
    del params, batch, logits, caches
    torch.cuda.empty_cache()
    return res, launches


def phase_lm_families(torch, flash, decode, smi) -> tuple[list, dict]:
    """Phase 15: the VLM, audio, MoE, SSM, hybrid and sliding-window
    families at full width through `serve`, their launches and routes,
    hymba's prefill past its window (`past_window_prefill`), their new
    kernel shapes against the plain versions, kernel route == plain route
    and prefill-then-decode at the cut (hymba also past its window).
    Returns (the kernels line's entries, results)."""
    from repro_torch.launch import serve as lm_serve
    from repro_torch.configs.base import get_config
    from repro_torch.models import layers, lm

    t_phase = time.perf_counter()
    results, shapes, fails = {}, {}, []
    for arch in LM_FAMILY_ARCHS:
        res, launches = family_serve(torch, flash, decode, layers, lm,
                                     lm_serve, arch, smi)
        results[arch] = res
        cfg = get_config(arch)
        b, gen = res["batch"], res["gen"]
        sq = res["prompt_len"] + (min(cfg.num_patches, 8)
                                  if cfg.family == "vlm" else 0)
        for kernel, table in launches.items():
            for key, n in table.items():
                info = shapes.setdefault((kernel, key), {
                    "launches_by_run": {}, "b": b, "h": cfg.num_heads,
                    "kvh": cfg.num_kv_heads})
                info["launches_by_run"][arch] = n
                if kernel == "decode":
                    # the last decode step's valid slots (whisper's cross
                    # attention: every frame)
                    cache = key[1]
                    info["valid"] = (cache if cache == cfg.encoder_seq
                                     and cfg.encoder_decoder
                                     else min(sq + gen - 1, cache))
    past, launches = past_window_prefill(torch, flash, layers, lm, lm_serve)
    run = f"{LM_PAST_WINDOW_ARCH}@{LM_PAST_WINDOW['prompt_len']}"
    results[run] = past
    cfg = get_config(LM_PAST_WINDOW_ARCH)
    for key, n in launches.items():
        shapes.setdefault(("flash", key), {
            "launches_by_run": {}, "b": LM_PAST_WINDOW["batch"],
            "h": cfg.num_heads, "kvh": cfg.num_kv_heads}
        )["launches_by_run"][run] = n
    t_serve = time.perf_counter() - t_phase
    entries, rows = lm_shape_entries(torch, flash, decode, shapes,
                                     "[lm families]")
    results["kernels"] = rows
    t_cuts = time.perf_counter()
    results["cut"] = {arch: family_cut(torch, lm, lm_serve, layers, arch,
                                       fails)
                      for arch in LM_FAMILY_ARCHS}
    results["cut"][run] = family_cut(
        torch, lm, lm_serve, layers, LM_PAST_WINDOW_ARCH, fails,
        prompt=LM_PAST_WINDOW["prompt_len"])
    results["phase_seconds"] = time.perf_counter() - t_phase
    t_cuts = time.perf_counter() - t_cuts
    say(f"[lm families] phase 15 {results['phase_seconds']:.1f}s (serving "
        f"{t_serve:.1f}s, kernel shapes "
        f"{results['phase_seconds'] - t_serve - t_cuts:.1f}s, cuts "
        f"{t_cuts:.1f}s)")
    assert not fails, "phase 15: " + "; ".join(fails)
    return entries, results


# ---------------------------------------------------------------- phase 5
def phase_shapes(torch, spmm, seen) -> dict:
    """The kernel at every shape phase 4 launched it at, on that launch's
    local_dst with random messages (pad messages are never read)."""
    rows_out = {}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for key in sorted(seen):
        combiner, rows, f = key
        ldst, dtype, kw = seen[key]
        msgs = torch.randn(ldst.numel(), f, device="cuda", generator=gen)
        msgs[ldst == kw.get("tile_v", 256)] = (
            0.0 if combiner == "sum" else float("-inf"))
        big = ldst.numel() * f > 1 << 26
        rows_out[key], _ = check_kernel(
            torch, spmm, f"main path rows={rows}", msgs.to(dtype), ldst, rows,
            combiner, reps=3 if big else 20, **kw)
        del msgs
        torch.cuda.empty_cache()
    layerwise = max(seen, key=lambda key: seen[key][0].numel())
    say(f"[shapes] largest layout (rows={layerwise[1]}): "
        f"{_padding(seen[layerwise][0].cpu().numpy())}")
    return rows_out


# ---------------------------------------------------------------- phase 6
def _attn_inputs(torch, shape_q, shape_kv, dtype, seed, kv_heads=None):
    """q and k, v from one seed, on the card. With `kv_heads`, k and v are
    drawn with that many heads and repeated to q's (models/layers.py
    _repeat_kv: each KV head serves H / kv_heads consecutive query heads)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(shape_q, device="cuda", generator=gen).to(dtype)
    if kv_heads is None:
        k = torch.randn(shape_kv, device="cuda", generator=gen).to(dtype)
        v = torch.randn(shape_kv, device="cuda", generator=gen).to(dtype)
        return q, k, v
    b, h, s, d = shape_kv
    small = (b, kv_heads, s, d)
    k = torch.randn(small, device="cuda", generator=gen).to(dtype)
    v = torch.randn(small, device="cuda", generator=gen).to(dtype)
    return (q, k.repeat_interleave(h // kv_heads, dim=1),
            v.repeat_interleave(h // kv_heads, dim=1))


def _attn_tol(dtype, n_keys: int) -> tuple[float, float]:
    """(rtol, atol) of a kernel against its plain version. bf16: the test
    file's 3e-2 / 0.15: the kernel rounds the unnormalised p to bf16 before
    PV, the oracle the normalised one, and the two bf16 outputs round once
    more. fp32: the test file's 2e-5 / 1e-4 up to 1024 keys, the atol grown
    as sqrt(keys / 1024) past that: the output is a weighted mean over up to
    `n_keys` terms summed in another order (tiles vs one matmul)."""
    if dtype == "bfloat16":
        return ATTN_TOL[dtype]
    rtol, atol = ATTN_TOL[dtype]
    return rtol, atol * math.sqrt(max(n_keys / 1024, 1.0))


def _row_rel_err(torch, out, plain) -> float:
    """The largest, over output rows (the last dim), of the row's largest
    |out - plain| over its largest |plain|."""
    diff = (out.float() - plain.float()).abs().amax(dim=-1)
    scale = plain.float().abs().amax(dim=-1).clamp_min(1e-30)
    return float((diff / scale).max())


def _hold_attn(torch, name, out, plain, dtype, n_keys):
    """Hold a kernel's output against its plain version: every dtype at
    `_attn_tol`, bf16 also per row at BF16_ROW_TOL. Returns the max abs
    error, the max row-relative error and the (rtol, atol) used."""
    rtol, atol = _attn_tol(dtype, n_keys)
    assert out.shape == plain.shape and out.dtype == plain.dtype, name
    assert bool(torch.isfinite(out.float()).all()), f"{name}: not finite"
    torch.testing.assert_close(out.float(), plain.float(), rtol=rtol,
                               atol=atol, msg=lambda m: f"{name}: {m}")
    rel = _row_rel_err(torch, out, plain)
    if dtype == "bfloat16":
        assert rel <= BF16_ROW_TOL, (
            f"{name}: row-relative error {rel:.3g} > {BF16_ROW_TOL}")
    return _max_abs_err(torch, out, plain), rel, (rtol, atol)


def _rejects(torch, name, wrong, plain, dtype, n_keys) -> None:
    """The check `_hold_attn` makes must fail on a wrong output."""
    try:
        _hold_attn(torch, name, wrong, plain, dtype, n_keys)
    except AssertionError:
        return
    raise AssertionError(f"{name}: the tolerance passes a wrong output")


def _attention_f64(torch, q, k, v, causal, window=0, valid=None, chunk=8):
    """Softmax attention in float64 over folded [BH, S, D] inputs (decode:
    q [BH, D] against the first `valid` slots), `chunk` heads at a time:
    the truth a kernel and its plain version are both held to."""
    if valid is not None:
        n = valid if valid >= 1 else k.shape[1]
        s = torch.einsum("bd,bkd->bk", q.double(), k[:, :n].double())
        if valid < 1:
            s = torch.zeros_like(s)  # every slot masked alike: the mean of v
        p = torch.softmax(s / math.sqrt(q.shape[-1]), dim=-1)
        return torch.einsum("bk,bkd->bd", p, v[:, :n].double())
    outs = []
    for lo in range(0, q.shape[0], chunk):
        sl = slice(lo, lo + chunk)
        s = torch.einsum("bqd,bkd->bqk", q[sl].double(), k[sl].double())
        s = s / math.sqrt(q.shape[-1])
        if causal:
            sq, sk = q.shape[1], k.shape[1]
            diff = (torch.arange(sq, device=q.device)[:, None]
                    - torch.arange(sk, device=q.device)[None, :])
            keep = diff >= 0
            if window:
                keep &= diff < window
            s = torch.where(keep, s, -1e30)
        outs.append(torch.einsum("bqk,bkd->bqd", torch.softmax(s, dim=-1),
                                 v[sl].double()))
        del s
    return torch.cat(outs)


def _hold_f64(name, out, plain, truth, dtype) -> dict:
    """The kernel's mean error against the float64 truth at most twice
    its plain version's, plus LM_FAMILY_CALL_FLOOR of the truth's mean
    magnitude (phase 15's per-call rule; it rejects a zeroed output)."""
    err = float((out.double() - truth).abs().mean())
    plain_err = float((plain.double() - truth).abs().mean())
    scale = float(truth.abs().mean())
    bound = 2 * plain_err + LM_FAMILY_CALL_FLOOR[dtype] * scale
    assert err <= bound, (f"{name}: mean error against float64 {err:.3g} > "
                          f"{bound:.3g} (plain {plain_err:.3g})")
    assert scale > bound, f"{name}: a zeroed output would pass"
    return {"f64_err": err, "plain_f64_err": plain_err, "f64_bound": bound}


def band_checks(torch, flash, decode) -> list:
    """The flash kernel with the causal band and at head dim 80
    (FLASH_BAND, FLASH_D80) and the decode kernel at head dim 80
    (DECODE_D80), fp32 and bf16: two launches bitwise equal, each held to
    its plain version (`_hold_attn`; the flash lse at LSE_TOL) and to
    float64 (`_hold_f64`); a band of W >= S bit for bit the call without
    one; the check shown to reject the output of a call that drops the
    band."""
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        name_t = str(dtype).removeprefix("torch.")
        cases = ([(bh, s, s, d, True, w) for bh, s, d, w in FLASH_BAND]
                 + [(bh, sq, skv, 80, causal, 0)
                    for bh, sq, skv, causal in FLASH_D80])
        for bh, sq, skv, d, causal, w in cases:
            q, k, v = _attn_inputs(torch, (bh, sq, d), (bh, skv, d), dtype,
                                   sq + skv + d + w)
            out, lse = flash.flash_attention(q, k, v, causal=causal,
                                             window=w, return_lse=True)
            assert torch.equal(out, flash.flash_attention(
                q, k, v, causal=causal, window=w)), "flash: repeat differs"
            plain, plain_lse = flash.flash_attention_plain(
                q, k, v, causal=causal, window=w, return_lse=True)
            name = (f"flash band {name_t} {bh}x{sq}x{skv}x{d} causal={causal}"
                    f" window={w}")
            n_keys = min(w, skv) if w else skv
            err, rel, tol = _hold_attn(torch, name, out, plain, name_t,
                                       n_keys)
            lse_err = float((lse - plain_lse).abs().max())
            assert lse_err <= LSE_TOL[name_t], f"{name}: lse {lse_err}"
            f64 = _hold_f64(name, out, plain,
                            _attention_f64(torch, q, k, v, causal, w),
                            name_t)
            if w >= sq:
                assert torch.equal(out, flash.flash_attention(
                    q, k, v, causal=causal)), f"{name}: W >= S changes bits"
            elif w and 4 * w <= sq:
                _rejects(torch, f"{name} without its band",
                         flash.flash_attention_plain(q, k, v, causal=True),
                         plain, name_t, n_keys)
            rows.append({"kernel": "flash", "shape": name, "err": err,
                         "row_rel_err": rel, "tol": tol, "lse_err": lse_err,
                         **f64})
            say(f"[attention] {name}: max |err| {err:.3g} row-relative "
                f"{rel:.3g} tol {tol}; lse {lse_err:.3g}; mean err vs "
                f"float64 {f64['f64_err']:.3g} (plain "
                f"{f64['plain_f64_err']:.3g})")
        for bh, s, valids in DECODE_D80:
            q, k, v = _attn_inputs(torch, (bh, 80), (bh, s, 80), dtype,
                                   bh + s + 80)
            for valid in valids:
                out = decode.decode_attention(q, k, v, valid)
                again = decode.decode_attention(
                    q, k, v, torch.tensor(valid, device="cuda"))
                assert torch.equal(out, again), "decode: repeat differs"
                plain = decode.decode_attention_plain(q, k, v, valid)
                name = f"decode D80 {name_t} {bh}x{s}x80 valid={valid}"
                err, rel, tol = _hold_attn(torch, name, out, plain, name_t,
                                           valid)
                f64 = _hold_f64(name, out, plain, _attention_f64(
                    torch, q, k, v, False, valid=valid), name_t)
                rows.append({"kernel": "decode", "shape": name, "err": err,
                             "row_rel_err": rel, "tol": tol, **f64})
                say(f"[attention] {name}: max |err| {err:.3g} row-relative "
                    f"{rel:.3g} tol {tol}; mean err vs float64 "
                    f"{f64['f64_err']:.3g} (plain {f64['plain_f64_err']:.3g})")
    return rows


def attention_checks(torch, flash, decode) -> list:
    """Each kernel against its plain version at the shapes of
    tests/test_kernels.py, at ragged shapes and at the decode edge cases
    (valid_len 0, 1, S, S + 5; the mean of v at 0), fp32 and bf16, with two
    launches on the same input bitwise equal."""
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        name_t = str(dtype).removeprefix("torch.")
        for bh, sq, skv, d, causal in [
                (2, 256, 256, 64, True), (2, 256, 256, 64, False),
                (2, 512, 512, 128, True), (2, 512, 512, 128, False),
                (2, 256, 1024, 64, False),
                (3, 200, 200, 128, True), (4, 77, 333, 64, False),
                (1, 1, 1, 128, True)] + STRADDLE:
            q, k, v = _attn_inputs(torch, (bh, sq, d), (bh, skv, d), dtype,
                                   bh + sq + skv + d)
            out = flash.flash_attention(q, k, v, causal=causal)
            again = flash.flash_attention(q, k, v, causal=causal)
            assert torch.equal(out, again), "flash: repeat differs"
            plain = flash.flash_attention_plain(q, k, v, causal=causal)
            name = f"flash {name_t} {bh}x{sq}x{skv}x{d} causal={causal}"
            err, rel, tol = _hold_attn(torch, name, out, plain, name_t, skv)
            rows.append({"kernel": "flash", "shape": name, "err": err,
                         "row_rel_err": rel, "tol": tol})
            say(f"[attention] {name}: max |err| {err:.3g} row-relative "
                f"{rel:.3g} tol {tol}")
        for bh, s, d, valids in [(2, 1024, 64, (700, 0, 1, 1024, 1029)),
                                 (8, 2048, 128, (2048, 0, 1, 2053)),
                                 (1, 1024, 64, (1,)),
                                 (3, 1000, 128, (999, 0, 1000, 1005)),
                                 (5, 5, 64, (3, 0))]:
            q, k, v = _attn_inputs(torch, (bh, d), (bh, s, d), dtype,
                                   bh + s + d)
            for valid in valids:
                for vl in (valid, torch.tensor(valid, device="cuda")):
                    out = decode.decode_attention(q, k, v, vl)
                    again = decode.decode_attention(q, k, v, vl)
                    assert torch.equal(out, again), "decode: repeat differs"
                    plain = decode.decode_attention_plain(q, k, v, valid)
                    name = (f"decode {name_t} {bh}x{s}x{d} valid={valid}"
                            f" ({type(vl).__name__})")
                    err, rel, tol = _hold_attn(
                        torch, name, out, plain, name_t,
                        min(valid, s) if valid > 0 else s)
                    rows.append({"kernel": "decode", "shape": name,
                                 "err": err, "row_rel_err": rel, "tol": tol})
                say(f"[attention] {name}: max |err| {err:.3g} row-relative "
                    f"{rel:.3g} tol {tol}")
            # valid_len <= 0: every slot is masked alike, the mean of v
            mean = v.float().mean(dim=1).to(dtype)
            _hold_attn(torch, f"decode {name_t} {bh}x{s}x{d} valid=0 vs mean",
                       decode.decode_attention(q, k, v, 0), mean, name_t, s)
        for bh, s, d in DECODE_STRADDLE:
            plan = decode._launch_plan(bh, s, d, dtype,
                                       decode._sm_count(torch.device("cuda")))
            assert plan.tile == DECODE_TILE[name_t][d], plan
            q, k, v = _attn_inputs(torch, (bh, d), (bh, s, d), dtype,
                                   bh + s + d)
            mean = v.float().mean(dim=1).to(dtype)
            for valid in decode_straddle_valids(plan, s):
                out = decode.decode_attention(q, k, v, valid)
                again = decode.decode_attention(
                    q, k, v, torch.tensor(valid, device="cuda"))
                assert torch.equal(out, again), "decode: repeat differs"
                n = decode.walked(valid, s)
                name = (f"decode straddle {name_t} {bh}x{s}x{d} valid={valid}"
                        f" (tile {plan.tile}, n_split {plan.n_split})")
                err, rel, tol = _hold_attn(
                    torch, name, out,
                    decode.decode_attention_plain(q, k, v, valid), name_t, n)
                if valid <= 0:
                    _hold_attn(torch, f"{name} vs mean", out, mean, name_t, s)
                rows.append({"kernel": "decode", "shape": name, "err": err,
                             "row_rel_err": rel, "tol": tol})
                say(f"[attention] {name}: max |err| {err:.3g} row-relative "
                    f"{rel:.3g} tol {tol}")
    return rows + band_checks(torch, flash, decode)


def decode_straddle_valids(plan, s: int) -> list:
    """valid_len values around the plan's tile and split boundaries: 1, a
    tile -1 / +1, n_split tiles -1 / +1, fewer slots than splits, 0 and -3
    (the mean of v), S and S + 5."""
    t, ns = plan.tile, plan.n_split
    vals = {1, t - 1, t + 1, ns * t - 1, ns * t + 1, max(ns - 1, 1), 0, -3,
            s, s + 5}
    return sorted(x for x in vals if x <= s + 5)


def _kept_pairs(sq, skv, causal, window=0) -> int:
    """The (query, key) pairs a flash call keeps: Sq Skv full; causal (Sq
    == Skv = S) S (S + 1) / 2, and with a band W < S W (W + 1) / 2 + (S -
    W) W."""
    if not causal:
        return sq * skv
    if window and window < sq:
        return window * (window + 1) // 2 + (sq - window) * window
    return sq * (sq + 1) // 2


def _attn_bound(dtype, bh, sq, skv, d, *, causal=False, valid=None,
                window=0):
    """(bound ms, bound by) of a flash call (q [bh, sq, d], k, v [bh, skv,
    d]; a causal call's band `window`) or, with `valid`, a decode call (sq
    = 1): the larger of the bytes the call must move (each input read once,
    the output written once; decode reads only the valid slots) over 3.35
    TB/s and its operations (QK^T and PV, 2 flops a multiply-add, over the
    kept (query, key) pairs, `_kept_pairs`, at the true d: 80 counts 80
    columns) over the peak for its type (bf16 tensor cores 989 TFLOP/s,
    fp32 outside them 67 TFLOP/s)."""
    b = 2 if dtype == "bfloat16" else 4
    peak = H100_BF16_FLOPS if dtype == "bfloat16" else H100_FP32_FLOPS
    if valid is not None:
        skv = min(max(valid, 0), skv) or skv  # valid_len <= 0 walks every slot
        nbytes = (2 * bh * sq * d + 2 * bh * skv * d) * b + 4
        pairs = skv
    else:
        nbytes = (2 * bh * sq * d + 2 * bh * skv * d) * b
        pairs = _kept_pairs(sq, skv, causal, window)
    ops = 4 * bh * d * pairs
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_attention(torch, ops, flash, decode) -> tuple[list, list]:
    """The attention main path at qwen3-4b widths, through the entry points
    (ops.flash_attention / ops.decode_attention), with the launch counters
    set to 0 just before and read just after; then each kernel against its
    plain version on those inputs, two launches bitwise equal, and kernel /
    plain / SDPA / bound times."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    checks = attention_checks(torch, flash, decode)
    h, kvh, d = QWEN3_4B["num_heads"], QWEN3_4B["num_kv_heads"], \
        QWEN3_4B["head_dim"]
    b, s = PREFILL["batch"], PREFILL["seq"]
    db, ds, valid = DECODE["batch"], DECODE["cache"], DECODE["valid_len"]
    F = torch.nn.functional
    entries, results = [], []
    for dtype in (torch.bfloat16, torch.float32):
        name_t = str(dtype).removeprefix("torch.")
        torch.cuda.empty_cache()
        # ---- prefill
        q, k, v = _attn_inputs(torch, (b, h, s, d), (b, h, s, d), dtype, 1,
                               kv_heads=kvh)
        flash.LAUNCHES.clear()
        out = ops.flash_attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        launches = sum(flash.LAUNCHES.values())
        assert launches > 0, "prefill: the flash kernel never launched"
        assert out.shape == q.shape and out.dtype == dtype
        fold = lambda x: x.reshape(b * h, x.shape[2], d)  # noqa: E731
        qf, kf, vf = fold(q), fold(k), fold(v)
        again = flash.flash_attention(qf, kf, vf, causal=True)
        assert torch.equal(again, fold(out)), "prefill: repeat differs"
        plain = flash.flash_attention_plain(qf, kf, vf, causal=True)
        err, rel, tol = _hold_attn(torch, f"prefill {name_t}", fold(out),
                                   plain, name_t, s)
        _rejects(torch, f"prefill {name_t} zeros", torch.zeros_like(plain),
                 plain, name_t, s)
        # a dropped ring stage: the last key tile's V rows never arrive
        dropped = vf.clone()
        dropped[:, -FLASH_BLOCK_K[name_t]:] = 0
        _rejects(torch, f"prefill {name_t} last key tile dropped",
                 flash.flash_attention_plain(qf, kf, dropped, causal=True),
                 plain, name_t, s)
        del plain, again, dropped
        backends = sdpa_backends(torch, q, k, v)
        say(f"[attention] sdpa backends prefill {name_t} [{b},{h},{s},{d}] "
            f"causal: {json.dumps(backends)}")
        lib_out = F.scaled_dot_product_attention(q, k, v, is_causal=True)
        lib_err = _max_abs_err(torch, lib_out, out)
        del lib_out
        ms = _time_ms(torch, lambda: flash.flash_attention(
            qf, kf, vf, causal=True), 10)
        plain_ms = _time_ms(torch, lambda: flash.flash_attention_plain(
            qf, kf, vf, causal=True), 5)
        library_ms = _time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True), 10)
        bound_ms, bound_by = _attn_bound(name_t, b * h, s, s, d, causal=True)
        entries.append(_attn_entry(
            f"flash_attention[{name_t},BH={b * h},S={s},D={d},causal]",
            "flash_attention.cu", "src/repro/kernels/flash_attention.py:32",
            launches, err, ms, plain_ms, bound_ms, bound_by, library_ms))
        results.append(dict(entries[-1], tol=tol, row_rel_err=rel,
                            library_max_abs_err=lib_err,
                            sdpa_backends=backends))
        say(f"[attention] prefill {name_t} [{b},{h},{s},{d}] causal: "
            f"launches {launches}, err {err:.3g} (tol {tol}), row-relative "
            f"{rel:.3g}, ms {ms:.4f} "
            f"plain {plain_ms:.4f} sdpa {library_ms:.4f} (sdpa vs kernel "
            f"{lib_err:.3g}) bound {bound_ms:.4f} ({bound_by})")
        del q, k, v, qf, kf, vf, out
        torch.cuda.empty_cache()
        # ---- decode
        q, k, v = _attn_inputs(torch, (db, h, d), (db, h, ds, d), dtype, 2,
                               kv_heads=kvh)
        decode.LAUNCHES.clear()
        out = ops.decode_attention(q, k, v, valid)
        torch.cuda.synchronize()
        launches = sum(decode.LAUNCHES.values())
        assert launches > 0, "decode: the decode kernel never launched"
        assert out.shape == q.shape and out.dtype == dtype
        qf, kf, vf = (q.reshape(db * h, d), k.reshape(db * h, ds, d),
                      v.reshape(db * h, ds, d))
        valid_t = torch.tensor(valid, dtype=torch.int32, device="cuda")
        plan = decode._launch_plan(db * h, ds, d, dtype,
                                   decode._sm_count(q.device))
        assert plan.tile == DECODE_TILE[name_t][d] and plan.n_split > 1, plan
        say(f"[attention] decode {name_t} plan: tile {plan.tile} slots, "
            f"{plan.stages} stages, n_split {plan.n_split}, grid "
            f"{plan.grid} x {decode.THREADS} threads, {plan.smem} B shared "
            f"memory, workspace {plan.workspace} floats")
        again = decode.decode_attention(qf, kf, vf, valid_t)
        assert torch.equal(again, out.reshape(db * h, d)), \
            "decode: repeat differs"
        plain = decode.decode_attention_plain(qf, kf, vf, valid)
        err, rel, tol = _hold_attn(torch, f"decode {name_t}",
                                   out.reshape(db * h, d), plain, name_t,
                                   valid)
        _rejects(torch, f"decode {name_t} zeros", torch.zeros_like(plain),
                 plain, name_t, valid)
        _rejects(torch, f"decode {name_t} half the cache",
                 decode.decode_attention_plain(qf, kf, vf, valid // 2),
                 plain, name_t, valid)
        # a lost split: the last one's share of the slots never merged
        last = int(decode.split_range(valid, plan.tile, plan.n_split,
                                      plan.n_split - 1)[0])
        _rejects(torch, f"decode {name_t} last split dropped (valid {last})",
                 decode.decode_attention_plain(qf, kf, vf, last), plain,
                 name_t, valid)
        del plain, again
        ks, vs = k[:, :, :valid], v[:, :, :valid]
        q4 = q[:, :, None]
        dec_backends = sdpa_backends(torch, q4, ks, vs, is_causal=False)
        say(f"[attention] sdpa backends decode {name_t} q [{db},{h},1,{d}] "
            f"cache [{db},{h},{valid},{d}]: {json.dumps(dec_backends)}")
        lib_out = F.scaled_dot_product_attention(q4, ks, vs)[:, :, 0]
        lib_err = _max_abs_err(torch, lib_out, out)
        del lib_out
        ms = _time_ms(torch, lambda: decode.decode_attention(
            qf, kf, vf, valid_t), 20)
        plain_ms = _time_ms(torch, lambda: decode.decode_attention_plain(
            qf, kf, vf, valid_t), 5)
        library_ms = _time_ms(torch, lambda: F.scaled_dot_product_attention(
            q4, ks, vs), 20)
        split_ms = {ns: _time_ms(torch, lambda ns=ns: decode._launch(
            qf, kf, vf, valid_t, _with_split(plan, db * h, d, ns)), 20)
            for ns in DECODE_SPLITS}
        say(f"[attention] decode {name_t} ms by n_split (plan's "
            f"{plan.n_split}: {ms:.4f}): "
            + ", ".join(f"{ns} {t:.4f}" for ns, t in split_ms.items()))
        bound_ms, bound_by = _attn_bound(name_t, db * h, 1, ds, d,
                                         valid=valid)
        entries.append(_attn_entry(
            f"decode_attention[{name_t},BH={db * h},S={ds},valid={valid},"
            f"D={d}]", "decode_attention.cu",
            "src/repro/kernels/decode_attention.py:26", launches, err, ms,
            plain_ms, bound_ms, bound_by, library_ms))
        results.append(dict(entries[-1], tol=tol, row_rel_err=rel,
                            library_max_abs_err=lib_err,
                            sdpa_backends=dec_backends,
                            plan=dataclasses.asdict(plan),
                            ms_by_n_split=split_ms))
        say(f"[attention] decode {name_t} q [{db},{h},{d}] cache "
            f"[{db},{h},{ds},{d}] valid {valid}: launches {launches}, err "
            f"{err:.3g} (tol {tol}), row-relative {rel:.3g}, ms {ms:.4f} "
            f"plain {plain_ms:.4f} sdpa "
            f"{library_ms:.4f} (sdpa vs kernel {lib_err:.3g}) bound "
            f"{bound_ms:.4f} ({bound_by})")
        del q, k, v, qf, kf, vf, ks, vs, q4, out
        torch.cuda.empty_cache()
    return entries, checks + results


def _with_split(plan, bh: int, d: int, n_split: int):
    """The decode plan with another n_split (grid and workspace to match)."""
    return dataclasses.replace(
        plan, n_split=n_split, grid=bh * n_split,
        workspace=bh * n_split * (d + 2) if n_split > 1 else 0)


def sdpa_backends(torch, q, k, v, is_causal=True) -> dict:
    """The yardstick named: SDPA's call on q, k, v timed under each backend
    `sdpa_kernel` lets run (ms, or why it would not run), and the device
    kernels the default dispatch launched (torch.profiler)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from torch.profiler import ProfilerActivity, profile

    F = torch.nn.functional
    call = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q, k, v, is_causal=is_causal)
    out = {}
    for backend in (SDPBackend.FLASH_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel(backend):
                out[backend.name] = _time_ms(torch, call, 5)
        except RuntimeError as exc:  # this backend does not take the call
            out[backend.name] = f"not run: {str(exc).splitlines()[0][:80]}"
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    out["default_kernels"] = sorted({e.name[:100] for e in prof.events()
                                     if e.device_type.name == "CUDA"})
    return out


def _attn_entry(name, source, replaces, launches, err, ms, plain_ms,
                bound_ms, bound_by, library_ms) -> dict:
    return {"name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}",
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


# --------------------------------------------------------------- phase 16
# the dist phase: phase 7's configuration (TRAIN_WIDTH, tiled) with one
# process a partition, the twin of the reference's shard_map mode; each
# run against the sim step of the same trainer on the card: (sync, model,
# steps, runs from scratch). Cut for the smoke's time: the halo runs from 3
# steps to 2, and ring GAT (~6.6 s a step on one card) to one run, its
# repeat bit for bit left to the halo runs
DIST_RUNS = [("halo", "sage", 2, 2), ("halo", "gat", 2, 2),
             ("ring", "gat", 2, 1)]
DIST_NCCL_RUN = ("halo", "gat", 2)
# the first step's gradient (the mean over the ranks of each rank's
# k * dL/dW_j) against the sim's dL/dW: the largest |dist - sim| of a leaf
# over that leaf's largest |sim|. A gradient off by a constant factor (k,
# the psum adjoint's) reads >= 0.75. Readings on the H100 (seed 0): halo
# SAGE 3.3e-4, halo GAT 2.3e-5, ring GAT 8.3e-7 (a rank's split segments
# round apart from the stack's, as below)
DIST_GRAD_TOL = 1e-3
# logits against the sim's, |dist - sim| / (1 + |sim|). Of the initial
# parameters: the reference's own multi-device tolerance
# (tests/test_dist_lowering.py:96); the kernel's split segments differ
# between a rank's [R] rows and the stack's [k * R], so sums round apart.
# After the steps, by model: Adam moves every weight by about lr a step
# whatever its gradient's size, so a gradient element near 0 whose last
# bits differ between the two summation orders takes a step of up to lr
# the other way. Readings on the H100 (seed 0): SAGE 1.34e-3 and 1.9e-3,
# GAT 7.3e-6 (halo) and 7.4e-6 (ring); the gradient itself is held above
DIST_LOGIT_TOL = {"logits_before": {"sage": 2e-4, "gat": 2e-4},
                  "logits_after": {"sage": 4e-3, "gat": 1e-4}}
DIST_TIMEOUT = 900.0
DIST_DEVICE = "cuda"


def dist_problem(gnn_train, ep, fullbatch):
    """Phase 7's problem and books on the host: the hep100 halo book
    (phase 7's own when it ran in this process) and the blockrow ring
    book, both with the tiled layout."""
    args = gnn_train.parser().parse_args(
        TRAIN_WIDTH + ["--model", "gat", "--agg-backend", "tiled"])
    g, feats, labels, train_mask, spec = gnn_train.problem(args)
    halo = STUDY_CLI.get("fullbatch gat tiled halo", {}).get("book")
    if halo is None:
        halo = fullbatch.build_book(
            g, ep.partition_edges(g, args.k, args.partitioner,
                                  seed=args.seed),
            args.k, sync_mode="halo", tiled_layout=True)
    ring = fullbatch.build_book(g, None, args.k, sync_mode="ring",
                                tiled_layout=True)
    problem = dict(features=feats, labels=labels, train_mask=train_mask)
    return args, spec, {"halo": halo, "ring": ring}, problem


def dist_shapes(torch, tiling, spec, books) -> dict:
    """Rank 0's layout at every (combiner, rows, F) a dist rank launches
    the kernel at (halo: R rows of one partition; ring: one chunk's),
    for `phase_shapes` (the stack's k * R rows are phase 5's)."""
    seen = {}
    for sync, book in books.items():
        if sync == "ring":
            n, ldst = book.v_block + 1, book.chunk_agg_ldst[0, 0]
        else:
            n, ldst = book.v_max + 1, book.agg_ldst[0]
        rows = tiling.tiled_shape(n, 256)[0]
        t = torch.as_tensor(np.ascontiguousarray(ldst), device=DIST_DEVICE)
        for model in ("gat", "sage"):
            for c, f in expected_launches(
                    dataclasses.replace(spec, model=model), 1):
                seen[(c, rows, f)] = (t, torch.float32,
                                      {"tile_v": 256, "block_e": 512})
    return seen


def _dist_sim(torch, fullbatch, models, book, spec, sync, steps, args,
              problem):
    """The sim trainer on the card over the same book: its first
    gradient dL/dW, its logits before and after, losses and step
    seconds."""
    tr = fullbatch.FullBatchTrainer.from_book(
        book, spec, sync_mode=sync, seed=args.seed, lr=float(TRAIN_LR),
        device=torch.device(DIST_DEVICE), **problem)
    loss_of, _ = tr._step_fns
    _, grads = models.per_partition_grads(
        lambda p: loss_of(p, tr.blocks), tr.params, k=book.k, stacked=False)
    grads = [{key: g.cpu().numpy() for key, g in layer.items()}
             for layer in grads["layers"]]
    before = tr.forward_logits_global()
    losses, seconds = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(tr.train_step())
        seconds.append(time.perf_counter() - t0)
    after = tr.forward_logits_global()
    del tr
    torch.cuda.empty_cache()
    return {"grads": grads, "logits_before": before, "logits_after": after,
            "losses": losses, "step_seconds": seconds}


def _hold_rank_launches(what, launches, want, rows) -> None:
    got = _by_combiner_width(launches)
    assert got == want and {r for (_, r, _) in launches} == {rows}, (
        f"{what} launched {launches}, expected {want} at rows {rows}")


def _hold_dist(name, runs, sim, spec, steps, stages, rows, book, sync_mod,
               sync):
    """One dist training beside its sim twin: every rank's losses and
    parameters the same bits, a second run (where the job ran two) == the
    first bit for bit,
    the kernel launched as `expected_launches` counts on every rank at the
    rank's rows, a forward's bytes == the accounting / k. Returns the
    summary, with the first gradient, losses and logits against the sim's
    (held by `_hold_dist_vs_sim` once printed), and the launches (summed
    over ranks and runs)."""
    k = len(runs)
    first = runs[0]["runs"][0]
    for rank, res in enumerate(runs):
        assert res["jax_loaded"] is False, f"{name}: rank {rank} loaded jax"
        a, b = res["runs"][0], res["runs"][-1]
        assert a["losses"] == first["losses"], (
            f"{name}: rank {rank} losses {a['losses']} vs rank 0's "
            f"{first['losses']}")
        for pa, p0, pb in zip(a["params"]["layers"],
                              first["params"]["layers"],
                              b["params"]["layers"]):
            for key in pa:
                assert np.array_equal(pa[key], p0[key]), (
                    f"{name}: rank {rank} {key} differs from rank 0's")
                assert np.array_equal(pa[key], pb[key]), (
                    f"{name}: rank {rank} {key}: the second run differs")
        assert a["losses"] == b["losses"], (
            f"{name}: rank {rank} second run {b['losses']} vs {a['losses']}")
        _hold_rank_launches(f"{name}: rank {rank}", a["launches"],
                            expected_launches(spec, steps, stages), rows)
        sent = sum(a["forward_sent"].values())
        acct = sum(sync_mod.sync_bytes_per_round(book, d, sync)
                   for dims in spec.aggregate_dims(sync) for d in dims)
        assert sent * k == acct, (
            f"{name}: rank {rank} forward handed {sent} B, accounting "
            f"{acct} / {k}")
    grad_err = 0.0
    for res in runs:
        for got, want in zip(res["runs"][0]["grads"]["layers"],
                             sim["grads"]):
            for key, w in want.items():
                g = got[key]
                assert g.shape == w.shape and np.isfinite(g).all()
                grad_err = max(grad_err, float(
                    np.max(np.abs(g - w)) / max(np.max(np.abs(w)), 1e-30)))
    errs = {}
    for when in ("logits_before", "logits_after"):
        got, want = first[when], sim[when]
        assert got.shape == want.shape and np.isfinite(got).all()
        errs[when] = float(np.max(np.abs(got - want)
                                  / (1.0 + np.abs(want))))
    launches = {}
    for res in runs:
        for run in res["runs"]:
            for key, n in run["launches"].items():
                launches[key] = launches.get(key, 0) + n
    per_rank = []
    for rank, res in enumerate(runs):
        a = res["runs"][0]
        walls = a["step_seconds"]
        per_rank.append({
            "step_seconds": walls,
            "warm_step_seconds": float(np.median(walls[1:])),
            "stage_share": [c / w for c, w in zip(a["stage_seconds"],
                                                   walls)],
            "collective_share": [c / w for c, w in
                                 zip(a["collective_seconds"], walls)],
            "peak_bytes": a["peak_bytes"],
            "forward_bytes": sum(a["forward_sent"].values()),
            "step_bytes": [sum(x.values()) for x in a["step_sent"]],
            "launches_per_step": {f"{c} F={f}": n / steps for (c, _, f), n
                                  in sorted(a["launches"].items())}})
    dloss = max(abs(a - b) for a, b in zip(first["losses"], sim["losses"]))
    # a rank's seconds inside gloo hold its wait for the slowest peer; the
    # least over the ranks is the nearest to the transport alone
    least = [min(r["collective_share"][i] for r in per_rank)
             for i in range(steps)]
    return {"losses": first["losses"], "sim_losses": sim["losses"],
            "repeated": len(runs[0]["runs"]) > 1,
            "sim_step_seconds": sim["step_seconds"], "model": spec.model,
            "max_abs_dloss_vs_sim": dloss, "grad_err": grad_err,
            "logit_err": errs, "least_collective_share": least,
            "ranks": per_rank}, launches


def _hold_dist_vs_sim(name, res) -> None:
    """The dist run's first gradient within DIST_GRAD_TOL of the sim's on
    every rank, its losses within LOSS_TOL, its logits within
    DIST_LOGIT_TOL (|dist - sim| / (1 + |sim|), the largest)."""
    assert res["grad_err"] <= DIST_GRAD_TOL, (
        f"{name} first gradient: error {res['grad_err']:.3g} over "
        f"{DIST_GRAD_TOL}")
    hold_losses(res["losses"], res["sim_losses"], f"{name} vs sim")
    for when, err in res["logit_err"].items():
        tol = DIST_LOGIT_TOL[when][res["model"]]
        assert err <= tol, f"{name} {when}: error {err:.3g} over {tol}"


def phase_dist(torch, spmm, tiling, gnn_train, ep, fullbatch, models,
               sync_mod, ranks, dist_jobs) -> tuple[dict, dict, dict]:
    """Full-batch training with one process a partition (mode "dist"), 4
    ranks on the one card under gloo, at phase 7's widths: DIST_RUNS
    (the halo runs twice from scratch in the same ranks), held against the
    sim step of the same trainer on the card (`_hold_dist`); then the NCCL
    leg when
    there is a card a rank. Times the kernel at the ranks' shapes first
    (`dist_shapes`). Returns the results, the launches by run and the
    shapes' rows."""
    t0 = time.perf_counter()
    args, spec, books, problem = dist_problem(gnn_train, ep, fullbatch)
    say(f"[dist] books: halo (hep100) bucket {books['halo'].bucket}, v_max "
        f"{books['halo'].v_max}; ring v_block {books['ring'].v_block}, "
        f"c_max {books['ring'].c_max} ({time.perf_counter() - t0:.1f}s)")
    shape_rows = phase_shapes(torch, spmm, dist_shapes(torch, tiling, spec,
                                                       books))
    sims, jobs = {}, []
    for sync, model, steps, n_runs in DIST_RUNS:
        m_spec = dataclasses.replace(spec, model=model)
        sims[(sync, model)] = _dist_sim(torch, fullbatch, models,
                                        books[sync], m_spec, sync, steps,
                                        args, problem)
        jobs.append(("train", dict(
            book=books[sync], spec=m_spec, sync_mode=sync, steps=steps,
            seed=args.seed, lr=float(TRAIN_LR), runs=n_runs, grads=True,
            **problem)))
    t_sim = time.perf_counter() - t0
    # the ranks' allocator is training's; the parent's cached blocks go
    # back to the card before they start
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = gnn_train.TRAIN_ALLOC_CONF
    torch.cuda.empty_cache()
    say(f"[dist] parent holds {torch.cuda.memory_allocated() / 2**30:.2f} "
        f"GiB on the card; spawning {args.k} gloo ranks")
    t1 = time.perf_counter()
    got = ranks.run_ranks(dist_jobs.run_jobs, args.k, backend="gloo",
                          device=DIST_DEVICE, args=(jobs,),
                          timeout=DIST_TIMEOUT)
    t_ranks = time.perf_counter() - t1
    results, launches = {"backend": "gloo", "ranks": args.k}, {}
    for i, (sync, model, steps, _) in enumerate(DIST_RUNS):
        book = books[sync]
        n = book.v_block + 1 if sync == "ring" else book.v_max + 1
        rows = tiling.tiled_shape(n, 256)[0]
        name = f"dist {sync} {model}"
        res, launches[name] = _hold_dist(
            name, [r[i] for r in got], sims[(sync, model)],
            dataclasses.replace(spec, model=model), steps,
            args.k if sync == "ring" else 1, rows, book, sync_mod, sync)
        results[f"{sync} {model}"] = res
        say(f"[dist] {name} (gloo, {args.k} ranks on one card): losses "
            f"{res['losses']} vs sim {res['sim_losses']} (max |dloss| "
            f"{res['max_abs_dloss_vs_sim']:.3g}), first gradient error "
            f"{res['grad_err']:.3g} (limit {DIST_GRAD_TOL}), logits error "
            f"{res['logit_err']} (limits {DIST_LOGIT_TOL}); "
            + ("a second run equal bit for bit; " if res["repeated"] else "")
            + f"share of a step inside gloo, least over the ranks "
            f"{[round(x, 3) for x in res['least_collective_share']]}")
        say(f"[dist]   sim step seconds "
            f"{[round(x, 4) for x in res['sim_step_seconds']]}; a forward "
            f"hands each rank's collectives "
            f"{res['ranks'][0]['forward_bytes']} B == the accounting / k")
        for rank, r in enumerate(res["ranks"]):
            say(f"[dist]   rank {rank}: step seconds "
                f"{[round(x, 4) for x in r['step_seconds']]}, warm "
                f"{r['warm_step_seconds']:.4f}s, share staging "
                f"{[round(x, 3) for x in r['stage_share']]} and inside gloo "
                f"{[round(x, 3) for x in r['collective_share']]}, peak "
                f"{r['peak_bytes'] / 2**30:.2f} GiB, bytes a step "
                f"{r['step_bytes']}, launches a step "
                f"{r['launches_per_step']}")
        _hold_dist_vs_sim(name, res)
    if torch.cuda.device_count() >= args.k:
        sync, model, steps = DIST_NCCL_RUN
        job = dict(jobs[[r[:2] for r in DIST_RUNS].index((sync, model))][1],
                   runs=2)
        got = ranks.run_ranks(dist_jobs.run_jobs, args.k, backend="nccl",
                              device="cuda", args=([("train", job)],),
                              timeout=DIST_TIMEOUT)
        book = books[sync]
        res, launches[f"dist nccl {sync} {model}"] = _hold_dist(
            f"dist nccl {sync} {model}", [r[0] for r in got],
            sims[(sync, model)], job["spec"], steps, 1,
            tiling.tiled_shape(book.v_max + 1, 256)[0], book, sync_mod, sync)
        results[f"nccl {sync} {model}"] = res
        say(f"[dist] nccl {sync} {model} ({args.k} cards): losses "
            f"{res['losses']} vs sim {res['sim_losses']}, first gradient "
            f"error {res['grad_err']:.3g}, logits error "
            f"{res['logit_err']}, rank step seconds "
            f"{[r['step_seconds'] for r in res['ranks']]}")
        _hold_dist_vs_sim(f"dist nccl {sync} {model}", res)
    else:
        results["nccl"] = (f"not run: {torch.cuda.device_count()} card(s) "
                           f"visible; NCCL needs one card a rank")
        say(f"[dist] NCCL leg {results['nccl']}")
    results.update(seconds=time.perf_counter() - t0, sim_seconds=t_sim,
                   ranks_seconds=t_ranks)
    say(f"[dist] phase {results['seconds']:.1f}s (shapes and sim "
        f"{t_sim:.1f}s, ranks {t_ranks:.1f}s)")
    return results, launches, shape_rows


# --------------------------------------------------------------- phase 17
# LM training: qwen3-4b at full width (src/repro/configs/qwen3_4b.py),
# depth cut to 16 of its 36 layers (the reference's out-of-place Adam holds
# params, grads, fp32 moments and their new copies, ~22 B a parameter: 36
# layers, 4.41 B parameters, need ~97 GB; 16 layers, 2.39 B, ~53 GB), batch
# 2, seq 2048, remat, 4 steps of loss -> autograd -> clip_by_global_norm
# (1.0) -> adam_update (lr 3e-4), the reference's train.py defaults;
# random weights and tokens from seed 0
LM_TRAIN_ARCH = "qwen3-4b"
LM_TRAIN = {"num_layers": 16, "batch": 2, "seq": 2048, "steps": 4}
LM_TRAIN_LR = 3e-4
LM_TRAIN_CLIP = 1.0
# the kernel route against the plain route: the same widths, 2 layers
LM_TRAIN_CUT_LAYERS = 2
# h2o-danube-1.8b uncut (src/repro/configs/h2o_danube_18b.py: 24 layers,
# d_model 2560, 32 heads of 80, 8 KV heads, window 4096; 1.83 B
# parameters, ~40 GB with the out-of-place Adam), batch 1, seq 8192 (two
# windows: the band is live in the forward and both backward kernels), the
# step of (b), 4 steps; its kernel route against the plain route at
# LM_TRAIN_CUT_LAYERS layers, the same batch and seq
LM_TRAIN_UNCUT_ARCH = "h2o-danube-1.8b"
LM_TRAIN_UNCUT = {"num_layers": 24, "batch": 1, "seq": 8192, "steps": 4}
# hymba-1.5b at the reference's train_4k sequence (src/repro/configs/
# base.py: 4096), full width cut to (f)'s 5 layers (3 global, 2 windowed
# at 2048: the band is live), batch 1: the kernel route against the plain
# route, as (c)
LM_TRAIN_4K_ARCH = "hymba-1.5b"
LM_TRAIN_4K = {"num_layers": 5, "batch": 1, "seq": 4096}
# the attention projections whose gradient (c) zeroes, in turn, until its
# check rejects one
LM_TRAIN_ZEROED = ("wq", "wk", "wv", "wo")
# the fp32 kernel route's worst leaf (mean error over mean) against the
# fp32 plain route where LM_TRAIN_FP32_GRAD_REL (qwen3-4b's) is not the
# bound (h2o-danube, hymba): at most LM_TRAIN_F32_NOISE x the plain
# route's own conditioning (the worst leaf's change when every fp32
# weight moves by one ulp) + LM_TRAIN_FP32_GRAD_REL; the noise factor is
# tests/test_torch_lm_train.py's F32_GRAD_NOISE
LM_TRAIN_F32_NOISE = 4.0
# one step's gradients at the cut: each leaf's mean error against the
# plain route's fp32 gradients (the same bf16 weights) at most this many
# times the plain route's own bf16 error, plus a floor of the fp32
# gradient's mean magnitude (tests/test_torch_lm_train.py's bf16 rule;
# the floor keeps a leaf where both bf16 runs land on the fp32 value)
LM_TRAIN_GRAD_RATIO = 3.0
LM_TRAIN_GRAD_FLOOR = 2.0 ** -8
# the fp32 cut's kernel-route gradients against the plain route's: each
# leaf's mean |kernel - plain| over its mean |plain| at most this; twice
# the worst leaf (7.788e-6) of the fp32 FMA backward that the 3xTF32
# kernel replaced, measured on an H100 80GB HBM3 at 700 W
LM_TRAIN_FP32_GRAD_REL = 1.56e-5
# the backward kernel's shapes (b, h, sq, skv, d, dtype, causal, what),
# K/V with the arch's KV heads repeated (kv): the step's (bf16, and fp32
# as the fp32 cut launches it), PERF.md row 3's (bf16 and fp32), hymba's
# (bf16 and fp32), whisper's encoder and prefill cross-attention
# (b, h, sq, skv, d, dtype, causal, window, kv heads, what); with the band:
# h2o-danube's training step (batch 1, seq 8192, D 80, window 4096) and
# its prefill shape (batch 4) in both dtypes, hymba at train_4k (batch 1,
# seq 4096, window 2048) in both
FLASH_BWD_SHAPES = [
    (2, 32, 2048, 2048, 128, "bfloat16", True, 0, 8, "qwen3-4b step"),
    (2, 32, 2048, 2048, 128, "float32", True, 0, 8, "qwen3-4b step"),
    (1, 32, 4096, 4096, 128, "bfloat16", True, 0, 8, "row 3"),
    (1, 32, 4096, 4096, 128, "float32", True, 0, 8, "row 3"),
    (4, 25, 2048, 2048, 64, "bfloat16", True, 0, 5, "hymba"),
    (4, 25, 2048, 2048, 64, "float32", True, 0, 5, "hymba"),
    (4, 6, 1536, 1536, 64, "bfloat16", False, 0, 6, "whisper encoder"),
    (4, 6, 448, 1536, 64, "bfloat16", False, 0, 6,
     "whisper cross-attention"),
    (1, 32, 8192, 8192, 80, "bfloat16", True, 4096, 8, "danube step"),
    (4, 32, 8192, 8192, 80, "bfloat16", True, 4096, 8, "danube prefill"),
    (4, 32, 8192, 8192, 80, "float32", True, 4096, 8, "danube prefill"),
    (1, 25, 4096, 4096, 64, "bfloat16", True, 2048, 5, "hymba train_4k"),
    (1, 25, 4096, 4096, 64, "float32", True, 2048, 5, "hymba train_4k"),
]
# forward rows with the band beyond those the LM runs time
# (`lm_shape_entries`, `lm_train_fwd_entry`): (b, h, s, d, dtype, window,
# kv heads, what); danube's prefill in fp32, at the reference's
# prefill_32k length (timed alone), hymba at train_4k in both dtypes
FLASH_FWD_BAND_SHAPES = [
    (4, 32, 8192, 80, "float32", 4096, 8, "danube prefill"),
    (1, 32, 32768, 80, "bfloat16", 4096, 8, "danube prefill_32k"),
    (1, 25, 4096, 64, "bfloat16", 2048, 5, "hymba train_4k"),
    (1, 25, 4096, 64, "float32", 2048, 5, "hymba train_4k"),
]
# a plain version's call at most this many fp32 scores at once: past it
# the call runs over slices of BH (`_by_heads`), its time summed; and a
# backward's float64 truth is taken over its first F64_HEADS heads (the
# danube rows: 128 heads of 8192 x 8192)
PLAIN_SCORES = 1 << 30
F64_HEADS = 16
# Sq = Skv one short of and one past the kernels' 32-row (fp32) and 64-row
# (bf16) q tiles of dK / dV, their 32-key (fp32) and 64-key (bf16) tiles of
# dQ, and their 128-key (dK / dV) and 128-row (dQ) blocks, and 257; a full
# call whose Skv is no multiple of a tile: (sq, skv, d, causal) at B 1, H 2
# in both dtypes, through the same holds
FLASH_BWD_STRADDLE = [(s, s, d, causal)
                      for s in (31, 33, 63, 65, 127, 129, 257)
                      for d in (64, 128) for causal in (True, False)] + [
                          (200, 1000, 64, False), (200, 1000, 128, False)]
# the band and head dim 80 in the backward, through the same holds: (sq,
# skv, d, causal, window) at B 1, H 2, both dtypes; phase 6's FLASH_BAND
# windows at S 1100 (no multiple of any tile; with a band of 1, P is 1 on
# the diagonal and dP = delta, so the float64 dq and dk are 0 and are held
# at an absolute scale of 1, `_bwd_errors`); and head dim 80 causal at
# 257 and full at Sq 200, Skv 1000 (fp32 at D 128 with a band below S:
# the kernel refuses it, shown)
FLASH_BWD_BAND = [(s, s, d, True, w) for _, s, d, w in FLASH_BAND] + [
    (sq, skv, 80, causal, 0) for _, sq, skv, causal in FLASH_D80]
# kernel against plain version: the largest |kernel - plain| of dq, dk, dv
# over the largest |plain|. fp32: both accumulate fp32-accurate products,
# in other orders (the kernel's 3xTF32 tensor-core steps, added in fp32 a
# tile at a time, against one matmul). bf16: the plain version
# rounds the scores and dout V^T to bf16 where the reference does, the
# kernel keeps them in fp32 and rounds P and dS to bf16 as wgmma operands;
# the two land up to a few bf16 ulps apart
FLASH_BWD_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -5}
# against float64 (the same inputs, autograd of the softmax attention):
# the kernel's mean error at most this many times the plain version's
FLASH_BWD_F64_RATIO = 2.0
# the forward's lse against its plain version's, absolute: the plain
# version takes the scores from a bf16 product (the reference's), the
# kernel from fp32 sums; a score of |s| < 8 is off by up to 2^-6 there
LSE_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -5}
LM_TRAIN_DEVICE = "cuda"
# (e) the reference's selective remat policy, "ssm_proj"
# (src/repro/models/lm.py:60-69; it keeps the SSM in-projection for the
# recompute), on mamba2-370m at full width (src/repro/configs/
# mamba2_370m.py: d_model 1024, an in-projection 4384 wide), its depth cut
# from 48 to 12 layers for the smoke's time (at 48, a step takes 12-19 s
# off and 18-24 s on, and the whole smoke ran past its time on an H100
# 80GB HBM3 at 700 W: 1220.2 s of command, this run 75.9 s of it;
# PERF.md §5), batch 1 at the train_4k sequence its comment prices
# (4096), bf16, remat; the step of (b); the policy off and then on, each
# from seed 2's weights and batch, 1 cold step and `warm_steps` (cut from
# 2 for the smoke's time, the selective checkpoint's dispatch mode costing
# 19-26 us an aten op, PERF.md)
LM_REMAT_ARCH = "mamba2-370m"
LM_REMAT = {"num_layers": 12, "batch": 1, "seq": 4096, "warm_steps": 1}
LM_REMAT_POLICY = "ssm_proj"
# (f) hymba-1.5b at full width cut to 5 of 32 layers (global 0, windowed
# 0, global 1, windowed 1, global 2), batch 1, seq 2048: no longer than
# the window, so flash takes every attention layer
LM_REMAT_CUT_ARCH = "hymba-1.5b"
LM_REMAT_CUT = {"num_layers": 5, "batch": 1, "seq": 2048}


def _attention_f64_grads(torch, q, k, v, dout, causal, chunk=8, window=0):
    """dq, dk, dv of softmax attention in float64 (autograd; the causal
    mask from the top left, Sq == Skv, and its band `window`), `chunk`
    heads at a time."""
    grads = [[], [], []]
    for lo in range(0, q.shape[0], chunk):
        sl = slice(lo, lo + chunk)
        q64, k64, v64 = (x[sl].double().requires_grad_() for x in (q, k, v))
        s = torch.einsum("bqd,bkd->bqk", q64, k64) / math.sqrt(q.shape[-1])
        if causal:
            sq, sk = q.shape[1], k.shape[1]
            diff = (torch.arange(sq, device=q.device)[:, None]
                    - torch.arange(sk, device=q.device)[None, :])
            keep = diff >= 0
            if window:
                keep &= diff < window
            s = torch.where(keep, s, -1e30)
        out = torch.einsum("bqk,bkd->bqd", torch.softmax(s, dim=-1), v64)
        for acc, g in zip(grads, torch.autograd.grad(
                out, (q64, k64, v64), dout[sl].double())):
            acc.append(g)
        del q64, k64, v64, s, out
    return [torch.cat(g) for g in grads]


def _bwd_errors(torch, got, plain, truth) -> dict:
    """Per gradient: the largest |kernel - plain| over the largest |plain|,
    whether the float64 truth is 0 throughout (a band of 1's dq and dk),
    the kernel's largest |value|, and both mean errors against the float64
    truth (over the truth's leading heads: all, or F64_HEADS of a call
    past PLAIN_SCORES)."""
    out = {}
    for name, g, p, t in zip(("dq", "dk", "dv"), got, plain, truth):
        n = t.shape[0]
        out[name] = {
            "rel_vs_plain": float((g.float() - p.float()).abs().max()
                                  / p.float().abs().max().clamp_min(1e-30)),
            "zero_truth": not bool(t.abs().max()),
            "largest": float(g.float().abs().max()),
            "max_abs_err": _max_abs_err(torch, g, p),
            "f64_err": float((g[:n].double() - t).abs().mean()),
            "plain_f64_err": float((p[:n].double() - t).abs().mean())}
    return out


def _hold_bwd(name, errs, dtype) -> None:
    """The backward kernel against its plain version (FLASH_BWD_TOL) and
    against float64 (FLASH_BWD_F64_RATIO x the plain version's error). A
    gradient that is 0 in float64 (a band of 1's dq and dk: P is 1 on the
    diagonal, so dP - delta is 0) has neither scale, and the plain
    version's value there is its own rounding (bf16: dout V^T rounded, up
    to ~2^-5): it is held to float64 at the absolute scale of 1, the
    kernel's largest |value| at most FLASH_BWD_TOL."""
    for grad, e in errs.items():
        if e["zero_truth"]:
            assert e["largest"] <= FLASH_BWD_TOL[dtype], (
                f"{name} {grad}: 0 in float64, the kernel's largest "
                f"|value| {e['largest']:.3g} > {FLASH_BWD_TOL[dtype]}")
            continue
        assert e["rel_vs_plain"] <= FLASH_BWD_TOL[dtype], (
            f"{name} {grad}: |kernel - plain| {e['rel_vs_plain']:.3g} of the "
            f"largest value > {FLASH_BWD_TOL[dtype]}")
        assert e["f64_err"] <= FLASH_BWD_F64_RATIO * e["plain_f64_err"], (
            f"{name} {grad}: mean error against float64 {e['f64_err']:.3g} "
            f"> {FLASH_BWD_F64_RATIO} x the plain version's "
            f"{e['plain_f64_err']:.3g}")


def _bwd_bound(dtype, bh, sq, skv, d, causal,
               window=0) -> tuple[float, str]:
    """(bound ms, bound by) of the backward: its five products of 2 D
    operations a kept (query, key) pair a head (`_kept_pairs`: causal and
    the band's) on the tensor cores, bf16 at 989 TFLOP/s, fp32 as three
    TF32 passes (3xTF32, the kernel's design) at 495, against the bytes it
    must move (q, k, v, out, dout and lse read once, dq, dk, dv written
    once) over 3.35 TB/s."""
    b = 2 if dtype == "bfloat16" else 4
    pairs = _kept_pairs(sq, skv, causal, window)
    ops = 5 * 2 * bh * d * pairs
    nbytes = (4 * bh * sq * d + 4 * bh * skv * d) * b + 4 * bh * sq
    t_ops = (ops / H100_BF16_FLOPS if dtype == "bfloat16"
             else 3 * ops / H100_TF32_FLOPS) * 1e3
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def _by_heads(torch, fn, tensors, sq, skv, **kw):
    """`fn` (a plain version) over slices of the folded BH of `tensors`,
    each slice's [bh, sq, skv] fp32 scores at most PLAIN_SCORES elements;
    the outputs concatenated along BH."""
    bh = tensors[0].shape[0]
    step = max(1, PLAIN_SCORES // (sq * skv))
    if step >= bh:
        return fn(*tensors, **kw)
    outs = [fn(*(t[lo:lo + step] for t in tensors), **kw)
            for lo in range(0, bh, step)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(x) for x in zip(*outs))
    return torch.cat(outs)


def _sdpa_call(torch, q, k, v, causal, window=0):
    """SDPA's call computing a flash call's function on the unfolded
    inputs: is_causal, or with a band W < Sq a boolean band `attn_mask`
    (True: kept; its backend is the dispatch's, named by `_sdpa_kernels`)."""
    F = torch.nn.functional
    sq = q.shape[2]
    if causal and window and window < sq:
        diff = (torch.arange(sq, device=q.device)[:, None]
                - torch.arange(sq, device=q.device)[None, :])
        mask = (diff >= 0) & (diff < window)
        return lambda q=q, k=k, v=v: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask)
    return lambda q=q, k=k, v=v: F.scaled_dot_product_attention(
        q, k, v, is_causal=causal)


def _library(torch, fn, *args):
    """`fn(torch, *args)` (a library yardstick's time or kernels), or
    None where SDPA cannot hold the call in the card's memory (its math
    backend materializes the scores); printed."""
    try:
        return fn(torch, *args)
    except torch.OutOfMemoryError as exc:
        torch.cuda.empty_cache()
        say(f"[library] out of memory, not timed: {str(exc)[:120]}")
        return None


def _sdpa_kernels(torch, call) -> list:
    """The device kernels one call of `call` launches (torch.profiler):
    the backend SDPA's dispatch took."""
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    return sorted({e.name[:100] for e in prof.events()
                   if e.device_type.name == "CUDA"})


def _sdpa_bwd_ms(torch, q, k, v, dout, causal, window=0) -> float:
    """The library yardstick: SDPA's backward under autograd (its default
    dispatch; with a band its boolean mask, `_sdpa_call`) on the unfolded
    inputs, the graph built once and replayed."""
    qs, ks, vs = (x.detach().requires_grad_() for x in (q, k, v))
    out = _sdpa_call(torch, qs, ks, vs, causal, window)()
    ms = _time_ms(torch, lambda: torch.autograd.grad(
        out, (qs, ks, vs), dout, retain_graph=True), 5)
    del qs, ks, vs, out
    return ms


def flash_bwd_straddle(torch, flash) -> None:
    """The backward kernel at FLASH_BWD_STRADDLE (B 1, H 2, both dtypes),
    from the forward kernel's out and lse: two launches bitwise equal, held
    against its plain version and float64 (`_hold_bwd`)."""
    t0 = time.perf_counter()
    worst = {}
    cases = ([(sq, skv, d, causal, 0)
              for sq, skv, d, causal in FLASH_BWD_STRADDLE] + FLASH_BWD_BAND)
    for sq, skv, d, causal, w in cases:
        for dtype in ("float32", "bfloat16"):
            tdt = getattr(torch, dtype)
            q, k, v = _attn_inputs(torch, (2, sq, d), (2, skv, d), tdt,
                                   sq + skv + d + int(causal) + w)
            if dtype == "float32" and 0 < w < sq and d == 128:
                # the fp32 backward takes no band at D 128: it refuses
                out, lse = flash.flash_attention(q, k, v, window=w,
                                                 return_lse=True)
                try:
                    flash.flash_attention_bwd(q, k, v, out, lse, q, window=w)
                except ValueError:
                    continue
                raise AssertionError(f"fp32 bwd band at D {d} ran")
            gen = torch.Generator(device=LM_TRAIN_DEVICE).manual_seed(sq + 2)
            dout = torch.randn((2, sq, d), device=LM_TRAIN_DEVICE,
                               generator=gen).to(tdt)
            out, lse = flash.flash_attention(q, k, v, causal=causal,
                                             window=w, return_lse=True)
            got = flash.flash_attention_bwd(q, k, v, out, lse, dout,
                                            causal=causal, window=w)
            again = flash.flash_attention_bwd(q, k, v, out, lse, dout,
                                              causal=causal, window=w)
            key = (2, sq, skv, d, dtype, causal, w)
            assert all(torch.equal(x, y) for x, y in zip(got, again)), (
                f"flash bwd straddle {key}: two launches differ")
            plain = flash.flash_attention_bwd_plain(q, k, v, out, lse, dout,
                                                    causal=causal, window=w)
            truth = _attention_f64_grads(torch, q, k, v, dout, causal,
                                         window=w)
            errs = _bwd_errors(torch, got, plain, truth)
            _hold_bwd(f"flash bwd straddle {key}", errs, dtype)
            most = worst.setdefault(dtype, [0.0, 0.0, 0.0])
            for e in errs.values():
                if e["zero_truth"]:
                    most[2] = max(most[2], e["largest"])
                    continue
                most[0] = max(most[0], e["rel_vs_plain"])
                most[1] = max(most[1],
                              e["f64_err"] / max(e["plain_f64_err"], 1e-30))
    say(f"[lm train] flash bwd at {len(cases)} tile-straddling, band and "
        "head-dim-80 shapes x 2 dtypes: repeats bit for bit; worst |kernel - "
        "plain| / "
        "largest, worst float64 error / plain's, largest |value| of a "
        "gradient 0 in float64 (window 1's dq, dk): "
        + ", ".join(f"{dt} {w[0]:.3g}, {w[1]:.3f}, {w[2]:.3g}"
                    for dt, w in worst.items())
        + f" ({time.perf_counter() - t0:.1f}s)")


def flash_bwd_checks(torch, flash) -> tuple[list, dict]:
    """(a): the backward kernel at FLASH_BWD_STRADDLE's shapes
    (`flash_bwd_straddle`), then at each FLASH_BWD_SHAPES shape from the
    forward kernel's out and lse: two launches bitwise equal, held against
    its plain version and float64 (`_hold_bwd`; shown to reject a zeroed
    dv tile at the step's shape), with kernel / plain / SDPA-backward /
    bound ms; and the forward at PERF.md row 3's shapes with the lse store
    off and on. Returns ({key: row}, forward times)."""
    flash_bwd_straddle(torch, flash)
    rows = {}
    for b, h, sq, skv, d, dtype, causal, w, kvh, what in FLASH_BWD_SHAPES:
        tdt = getattr(torch, dtype)
        q, k, v = _attn_inputs(torch, (b, h, sq, d), (b, h, skv, d), tdt,
                               sq + skv + d, kv_heads=kvh)
        gen = torch.Generator(device=LM_TRAIN_DEVICE).manual_seed(sq + 1)
        dout4 = torch.randn((b, h, sq, d), device=LM_TRAIN_DEVICE,
                            generator=gen).to(tdt)
        bh = b * h
        fold = lambda x: x.reshape(bh, x.shape[2], d)  # noqa: E731
        qf, kf, vf, dof = fold(q), fold(k), fold(v), fold(dout4)
        out, lse = flash.flash_attention(qf, kf, vf, causal=causal, window=w,
                                         return_lse=True)
        got = flash.flash_attention_bwd(qf, kf, vf, out, lse, dof,
                                        causal=causal, window=w)
        again = flash.flash_attention_bwd(qf, kf, vf, out, lse, dof,
                                          causal=causal, window=w)
        assert all(torch.equal(x, y) for x, y in zip(got, again)), (
            f"flash bwd {what}: two launches differ")
        plain_bwd = lambda: _by_heads(  # noqa: E731
            torch, flash.flash_attention_bwd_plain,
            (qf, kf, vf, out, lse, dof), sq, skv, causal=causal, window=w)
        plain = plain_bwd()
        # a call past PLAIN_SCORES: its first F64_HEADS heads in float64
        n = bh if bh * sq * skv <= PLAIN_SCORES else F64_HEADS
        truth = _attention_f64_grads(torch, qf[:n], kf[:n], vf[:n],
                                     dof[:n], causal, window=w)
        key = (bh, sq, skv, d, dtype, causal, w)
        name = f"flash bwd {what} {key}"
        errs = _bwd_errors(torch, got, plain, truth)
        _hold_bwd(name, errs, dtype)
        if what == "qwen3-4b step":
            wrong = list(got)
            wrong[2] = got[2].clone()
            wrong[2][:, :64] = 0  # one key tile's dv lost
            try:
                _hold_bwd(name, _bwd_errors(torch, wrong, plain, truth),
                          dtype)
            except AssertionError:
                say(f"[lm train] the check rejects a zeroed dv key tile "
                    f"at {key}")
            else:
                raise AssertionError("the backward check passes a zeroed "
                                     "dv tile")
            del wrong
        if what == "danube step":
            wrong = flash.flash_attention_bwd(qf, kf, vf, out, lse, dof,
                                              causal=causal)
            try:
                _hold_bwd(name, _bwd_errors(torch, wrong, plain, truth),
                          dtype)
            except AssertionError:
                say(f"[lm train] the check rejects the band dropped at "
                    f"{key}")
            else:
                raise AssertionError("the backward check passes the band "
                                     "dropped")
            del wrong
        del truth, again, plain
        ms = _time_ms(torch, lambda: flash.flash_attention_bwd(
            qf, kf, vf, out, lse, dof, causal=causal, window=w), 5)
        plain_ms = _time_ms(torch, plain_bwd, 2)
        library_ms = _library(torch, _sdpa_bwd_ms, q, k, v, dout4, causal, w)
        bound_ms, bound_by = _bwd_bound(dtype, bh, sq, skv, d, causal, w)
        rows[key] = {
            "what": what, "errors": errs, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by,
            "max_abs_err": max(e["max_abs_err"] for e in errs.values())}
        if w:
            rows[key]["library_kernels"] = _library(
                torch, _sdpa_kernels, _sdpa_call(torch, q, k, v, causal, w))
        say(f"[lm train] {name}: |kernel - plain| / largest "
            + ", ".join(f"{g} {e['rel_vs_plain']:.3g}"
                        for g, e in errs.items())
            + "; mean err vs float64 kernel / plain "
            + ", ".join(f"{g} {e['f64_err']:.3g} / {e['plain_f64_err']:.3g}"
                        for g, e in errs.items())
            + f"; repeats bit for bit; ms {ms:.4f} plain {plain_ms:.4f} "
            f"sdpa bwd {library_ms} bound {bound_ms:.4f} ({bound_by}"
            + (", 3xTF32)" if dtype == "float32" else ")")
            + (f"; sdpa's band kernels {rows[key]['library_kernels']}"
               if w else ""))
        del q, k, v, dout4, qf, kf, vf, dof, out, lse, got
        torch.cuda.empty_cache()

    # PERF.md row 3's forward, with the lse store off and on, A B B A
    fwd = {}
    for dtype in ("bfloat16", "float32"):
        q, k, v = _attn_inputs(torch, (32, 4096, 128), (32, 4096, 128),
                               getattr(torch, dtype), 4096 * 2 + 128)
        times = {False: [], True: []}
        for lse_on in (False, True, True, False):
            times[lse_on].append(_time_ms(torch, lambda: flash.flash_attention(
                q, k, v, causal=True, return_lse=lse_on), 10))
        out, lse = flash.flash_attention(q, k, v, causal=True,
                                         return_lse=True)
        assert torch.equal(out, flash.flash_attention(q, k, v, causal=True))
        _, plain_lse = flash.flash_attention_plain(q, k, v, causal=True,
                                                   return_lse=True)
        lse_err = float((lse - plain_lse).abs().max())
        assert lse_err <= LSE_TOL[dtype], f"row 3 {dtype}: lse {lse_err}"
        fwd[dtype] = {"ms_without_lse": times[False],
                      "ms_with_lse": times[True], "lse_max_abs_err": lse_err}
        say(f"[lm train] flash forward [1, 32, 4096, 128] causal {dtype}: "
            f"ms without lse {times[False]}, with lse {times[True]} (A B B "
            f"A); the output equal bit for bit; lse against the plain "
            f"version {lse_err:.3g}")
        del q, k, v, out, lse, plain_lse
        torch.cuda.empty_cache()
    return rows, fwd


def band_fwd_rows(torch, flash) -> dict:
    """The forward kernel at FLASH_FWD_BAND_SHAPES: two launches bitwise
    equal, held against its plain version (over slices of BH,
    `_by_heads`; the lse at LSE_TOL), with kernel / plain / SDPA (its band
    mask; the backend's kernels named) / bound ms. Returns {key: row}."""
    rows = {}
    for b, h, s, d, dtype, w, kvh, what in FLASH_FWD_BAND_SHAPES:
        tdt = getattr(torch, dtype)
        q, k, v = _attn_inputs(torch, (b, h, s, d), (b, h, s, d), tdt,
                               s + d + w, kv_heads=kvh)
        bh = b * h
        fold = lambda x: x.reshape(bh, s, d)  # noqa: E731
        qf, kf, vf = fold(q), fold(k), fold(v)
        out, lse = flash.flash_attention(qf, kf, vf, window=w,
                                         return_lse=True)
        assert torch.equal(out, flash.flash_attention(qf, kf, vf, window=w))
        plain_fwd = lambda: _by_heads(  # noqa: E731
            torch, flash.flash_attention_plain, (qf, kf, vf), s, s,
            window=w, return_lse=True)
        plain, plain_lse = plain_fwd()
        key = (bh, s, s, d, dtype, True, w)
        err, rel, tol = _hold_attn(torch, f"flash band {what} {key}", out,
                                   plain, dtype, min(w, s))
        lse_err = float((lse - plain_lse).abs().max())
        assert lse_err <= LSE_TOL[dtype], f"{what} {key}: lse {lse_err}"
        del plain, plain_lse, lse
        ms = _time_ms(torch, lambda: flash.flash_attention(
            qf, kf, vf, window=w), 10)
        plain_ms = _time_ms(torch, plain_fwd, 2)
        call = _sdpa_call(torch, q, k, v, True, w)
        library_ms = _library(torch, _time_ms, call, 10)
        library_kernels = _library(torch, _sdpa_kernels, call)
        bound_ms, bound_by = _attn_bound(dtype, bh, s, s, d, causal=True,
                                         window=w)
        rows[key] = {"what": what, "max_abs_err": err, "row_rel_err": rel,
                     "tol": tol, "lse_err": lse_err, "ms": ms,
                     "plain_ms": plain_ms, "library_ms": library_ms,
                     "library_kernels": library_kernels,
                     "bound_ms": bound_ms, "bound_by": bound_by}
        say(f"[lm train] flash fwd {what} {key}: err {err:.3g} (tol {tol}),"
            f" lse {lse_err:.3g}; repeats bit for bit; ms {ms:.4f} plain "
            f"{plain_ms:.4f} sdpa (band mask) {library_ms} "
            f"{library_kernels} bound {bound_ms:.4f} ({bound_by})")
        del q, k, v, qf, kf, vf, out, call
        torch.cuda.empty_cache()
    return rows


def _lm_grads(torch, optim, lm, cfg, params, batch, remat=True,
              use_pallas=None, backward_mode=None):
    """(loss, gradients as a tree like `params`) of `lm.loss_fn`; weights
    that take no part get zeros, as `jax.grad` gives them. The backward
    runs under `backward_mode` if one is given."""
    live = optim.tree_map(lambda t: t.detach().requires_grad_(), params)
    loss = lm.loss_fn(cfg, live, batch, remat=remat, use_pallas=use_pallas)
    with backward_mode or contextlib.nullcontext():
        grads = iter(torch.autograd.grad(loss, optim.leaves(live),
                                         materialize_grads=True))
    return loss.detach(), optim.tree_map(lambda _: next(grads), params)


def lm_train_step(torch, optim, lm, cfg, params, state, batch):
    """One step: loss -> autograd -> clip_by_global_norm -> adam_update.
    Returns (loss, grad norm, new params, new state)."""
    loss, grads = _lm_grads(torch, optim, lm, cfg, params, batch)
    clipped, norm = optim.clip_by_global_norm(grads, LM_TRAIN_CLIP)
    del grads
    params, state = optim.adam_update(clipped, state, params,
                                      lr=LM_TRAIN_LR)
    return loss, norm, params, state


def train_flash_launches(cfg, b: int, s: int, dtype: str,
                         steps: int) -> dict:
    """The flash launches of `steps` gradients of `lm.loss_fn` under
    remat: each layer's forward twice a step (the pass and its recompute
    in the backward), its backward once, keyed by the layer's band
    (`layer_windows`)."""
    bh, d = b * cfg.num_heads, cfg.resolved_head_dim
    keys = {(bh, s, s, d, dtype, True, w): n
            for w, n in layer_windows(cfg).items()}
    return {"flash": {k: 2 * n * steps for k, n in keys.items()},
            "flash_bwd": {k: n * steps for k, n in keys.items()}}


def lm_train_run(torch, flash, optim, lm, layers, cfg, arch, spec,
                 repeat=True) -> dict:
    """(b) and (d): `spec`'s steps of `cfg` (full width; `arch` cut to
    its `num_layers`) on one batch, the launches counted over them alone
    (`train_flash_launches`; no plain route), finite losses from near
    ln V; then, with `repeat`, one more gradient twice from the final
    state, bit for bit."""
    b, s, steps = spec["batch"], spec["seq"], spec["steps"]
    dev = LM_TRAIN_DEVICE
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            dev)
    state = optim.adam_init(params)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (b, s)), device=dev)
    batch = {"tokens": tokens}
    flash.LAUNCHES.clear()
    flash.BWD_LAUNCHES.clear()
    layers.ROUTES.clear()
    losses, norms, walls = [], [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, norm, params, state = lm_train_step(torch, optim, lm, cfg,
                                                  params, state, batch)
        losses.append(float(loss))  # read back: the step has ended
        norms.append(float(norm))
        walls.append(time.perf_counter() - t0)
    launches = {"flash": dict(flash.LAUNCHES),
                "flash_bwd": dict(flash.BWD_LAUNCHES)}
    routes = dict(layers.ROUTES)
    peak = torch.cuda.max_memory_allocated()
    n = cfg.num_layers
    # under remat each layer's forward runs twice a step: the forward pass
    # and its recompute in the backward; the backward once
    want = train_flash_launches(cfg, b, s, "bfloat16", steps)
    assert launches == want, (arch, launches, want)
    assert routes == {"flash": 2 * n * steps}, f"{arch}: routes {routes}"
    assert all(math.isfinite(x) for x in losses + norms), (losses, norms)
    ln_v = math.log(cfg.vocab_size)
    assert abs(losses[0] - ln_v) < 2.0, (losses[0], ln_v)

    same = None
    if repeat:  # (d) one more gradient, twice, from the final state
        g1 = _lm_grads(torch, optim, lm, cfg, params, batch)
        g2 = _lm_grads(torch, optim, lm, cfg, params, batch)
        same = torch.equal(g1[0], g2[0]) and all(
            torch.equal(x, y) for x, y in zip(optim.leaves(g1[1]),
                                              optim.leaves(g2[1])))
        assert same, f"lm train {arch}: a step's gradients differ"
        del g1, g2
    del params, state
    torch.cuda.empty_cache()
    warm = float(np.median(walls[1:]))
    out = {"arch": arch, **spec, "losses": losses, "grad_norms": norms,
           "step_seconds": walls, "warm_step_seconds": warm,
           "peak_bytes": peak,
           "launches": {k: {str(kk): v for kk, v in t.items()}
                        for k, t in launches.items()},
           "routes": routes, "repeat_bitwise": same, "ln_vocab": ln_v,
           "params": cfg.param_count()}
    say(f"[lm train] {arch} full width, {n} layers "
        f"({cfg.param_count():,} parameters, bf16), batch {b}, seq {s}, "
        f"remat: losses {losses} (ln V {ln_v:.4f}), grad norms {norms}; "
        f"step seconds {walls}, warm (median of steps 2-{steps}) "
        f"{warm:.4f}s; peak {peak / 2**30:.2f} GiB; launches flash "
        f"{launches['flash']}, flash bwd {launches['flash_bwd']} (2 x {n} "
        f"forwards and {n} backwards a step); routes {routes}"
        + ("; a step's gradients repeat bit for bit" if repeat else ""))
    return out


def _grad_mean_errors(torch, optim, got, plain16, truth) -> dict:
    """Per leaf (by position): (mean |got - truth|, mean |plain16 -
    truth|, mean |truth|)."""
    out = {}
    for i, (g, p, t) in enumerate(zip(optim.leaves(got),
                                      optim.leaves(plain16),
                                      optim.leaves(truth))):
        t = t.float()
        out[i] = (float((g.float() - t).abs().mean()),
                  float((p.float() - t).abs().mean()),
                  float(t.abs().mean()))
    return out


def _hold_grads(errs, what) -> float:
    """Every leaf: its mean error at most LM_TRAIN_GRAD_RATIO x the plain
    route's bf16 error plus LM_TRAIN_GRAD_FLOOR of the truth's mean
    magnitude. Returns the worst ratio of error to bound."""
    worst = 0.0
    for i, (err, own, scale) in errs.items():
        bound = LM_TRAIN_GRAD_RATIO * own + LM_TRAIN_GRAD_FLOOR * scale
        assert err <= bound, (f"{what}: leaf {i} mean error {err:.3g} > "
                              f"{bound:.3g}")
        worst = max(worst, err / bound if bound else 0.0)
    return worst


def _f32_conditioning(torch, optim, lm, c32, p32, batch, truth) -> float:
    """The fp32 plain route's own conditioning: the worst leaf's mean
    change over its mean when every weight of `p32` moves by one ulp, up
    or down at random (seed 9), against `truth` (its gradients at `p32`).
    tests/test_torch_lm_train.py measures the reference's so."""
    gen = torch.Generator(device=LM_TRAIN_DEVICE).manual_seed(9)

    def move(t):
        up = torch.rand(t.shape, device=t.device, generator=gen) < 0.5
        return torch.nextafter(t, torch.where(up, math.inf, -math.inf).to(
            t.dtype))

    _, moved = _lm_grads(torch, optim, lm, c32, optim.tree_map(move, p32),
                         batch, use_pallas=False)
    out = max(float((g - t).abs().mean() / t.abs().mean().clamp_min(1e-30))
              for g, t in zip(optim.leaves(moved), optim.leaves(truth)))
    del moved
    return out


@contextlib.contextmanager
def _recorded_bwd(flash, calls):
    """Every `flash.flash_attention_bwd` call (the kernel route's backward,
    through `ops._FlashAttention`) returns as before; its inputs, options
    and a copy of dout and of its gradients go to `calls`, to be held after
    the run (`_hold_bwd_calls`)."""
    orig = flash.flash_attention_bwd

    def recorded(q, k, v, out, lse, dout, *, causal=True, window=0):
        got = orig(q, k, v, out, lse, dout, causal=causal, window=window)
        calls.append({"inputs": tuple(t.detach() for t in (q, k, v, out,
                                                            lse))
                      + (dout.detach().clone(),),
                      "causal": causal, "window": window,
                      "got": tuple(g.clone() for g in got)})
        return got

    flash.flash_attention_bwd = recorded
    try:
        yield
    finally:
        flash.flash_attention_bwd = orig


def _bwd_call_errors(got, plain, truth) -> dict:
    """Per gradient: (mean |kernel - truth|, mean |plain - truth|, mean
    |truth|) over the truth's leading heads."""
    out = {}
    for name, g, p, t in zip(("dq", "dk", "dv"), got, plain, truth):
        n = t.shape[0]
        out[name] = (float((g[:n].double() - t).abs().mean()),
                     float((p[:n].double() - t).abs().mean()),
                     float(t.abs().mean()))
    return out


def _bwd_call_bound(dtype, own, scale) -> float:
    """`_hold_calls`' rule for one gradient: twice the yardstick's mean
    error against float64 plus LM_FAMILY_CALL_FLOOR of the truth's mean
    magnitude."""
    return 2 * own + LM_FAMILY_CALL_FLOOR[dtype] * scale


def _hold_bwd_calls(torch, flash, dtype, calls, what, fails) -> dict:
    """Every recorded backward call (`_recorded_bwd`) held as `_hold_calls`
    holds a forward call: each of dq, dk, dv against the float64 truth of
    the call's own inputs (`_attention_f64_grads`; the leading F64_HEADS
    heads of a call past PLAIN_SCORES) within `_bwd_call_bound` of the
    yardstick's error, the rule shown to reject a zeroed gradient; and at
    a call with a band below Sq, the same kernel with the band dropped
    (window 0, the forward's lse kept) shown to be rejected. The yardstick
    is the plain version in fp32 on the call's inputs: at the reference's
    init the model's scores spread ~800 wide (attention one-hot), where
    the bf16 plain version's bf16 scores (the reference's rounding) are
    off by whole units and its error is 20-700x the truth's mean (it
    would pass a zeroed gradient); in fp32 it carries the call's own
    conditioning. Returns the worst ratio of error to bound and the
    dropped bands rejected."""
    worst, dropped = 0.0, 0
    for i, c in enumerate(calls):
        q, k, v, out, lse, dout = c["inputs"]
        causal, w = c["causal"], c["window"]
        bh, sq, skv = q.shape[0], q.shape[1], k.shape[1]
        plain = _by_heads(torch, flash.flash_attention_bwd_plain,
                          tuple(t.float() for t in c["inputs"]), sq, skv,
                          causal=causal, window=w)
        n = bh if bh * sq * skv <= PLAIN_SCORES else F64_HEADS
        truth = _attention_f64_grads(torch, q[:n], k[:n], v[:n], dout[:n],
                                     causal, window=w)
        tag = f"{what} {dtype} backward call {i} {tuple(q.shape)} window {w}"
        for g, (err, own, scale) in _bwd_call_errors(c["got"], plain,
                                                     truth).items():
            bound = _bwd_call_bound(dtype, own, scale)
            if not err <= bound:
                fails.append(f"{tag} {g}: mean err {err:.3g} > {bound:.3g}")
            if not scale > bound:
                fails.append(f"{tag} {g}: a zeroed gradient passes")
            worst = max(worst, err / bound if bound else 0.0)
        if 0 < w < sq:
            wrong = flash.flash_attention_bwd(q, k, v, out, lse, dout,
                                              causal=causal)
            # not err <= bound: the band dropped under the band's lse
            # overflows to inf / nan at one-hot scores
            if any(not err <= _bwd_call_bound(dtype, own, scale)
                   for err, own, scale in _bwd_call_errors(
                       wrong, plain, truth).values()):
                dropped += 1
            else:
                fails.append(f"{tag}: the band dropped passes")
            del wrong
        del plain, truth
    torch.cuda.empty_cache()
    return {"calls": len(calls), "worst": worst,
            "dropped_band_rejected": dropped}


def lm_train_cut(torch, optim, lm, layers, flash, cfg, arch, b, s, fails,
                 fp32_rel=None) -> dict:
    """(c): `cfg` (full width, cut in depth), one step's gradients at batch
    `b`, seq `s` on the kernel route (every attention call held to float64
    as phase 15 holds it, `_checked_attention`, and so every backward
    kernel call, `_hold_bwd_calls`) against the plain route's,
    bf16 and the same weights in fp32 (`_hold_grads`; shown to reject a
    zeroed gradient); the kernel route's gradients once more, bit for bit;
    then the same weights' fp32 gradients on the kernel route, the fp32
    flash forward and backward kernels' caller (their launches counted),
    each leaf's mean error over its mean against the fp32 plain route's at
    most `fp32_rel` (None: LM_TRAIN_F32_NOISE x the plain route's own
    conditioning + LM_TRAIN_FP32_GRAD_REL, `_f32_conditioning`)."""
    c16 = cfg
    c32 = dataclasses.replace(c16, dtype="float32")
    n = c16.num_layers
    dev = LM_TRAIN_DEVICE
    params = lm.init_params(c16, torch.Generator(device=dev).manual_seed(1),
                            dev)
    tokens = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (b, s)), device=dev)
    batch = {"tokens": tokens}
    calls, bwd16 = [], []
    layers.ROUTES.clear()
    with _checked_attention(torch, layers, calls), _recorded_bwd(flash,
                                                                 bwd16):
        loss_k, kern = _lm_grads(torch, optim, lm, c16, params, batch)
    routes = dict(layers.ROUTES)
    assert routes == {"flash": 2 * n}, (arch, routes)
    worst_calls = _hold_calls("bfloat16", calls, f"lm train cut {arch}",
                              fails)
    bwd_calls = {"bf16": _hold_bwd_calls(torch, flash, "bfloat16", bwd16,
                                         f"lm train cut {arch}", fails)}
    del bwd16
    flash.LAUNCHES.clear()
    flash.BWD_LAUNCHES.clear()
    loss_r, again = _lm_grads(torch, optim, lm, c16, params, batch)
    launches16 = {"flash": {str(k): v for k, v in flash.LAUNCHES.items()},
                  "flash_bwd": {str(k): v
                                for k, v in flash.BWD_LAUNCHES.items()}}
    want16 = {kind: {str(k): v for k, v in t.items()} for kind, t in
              train_flash_launches(c16, b, s, "bfloat16", 1).items()}
    assert launches16 == want16, (arch, launches16, want16)
    repeat = torch.equal(loss_k, loss_r) and all(
        torch.equal(x, y) for x, y in zip(optim.leaves(kern),
                                          optim.leaves(again)))
    assert repeat, f"lm train cut {arch}: two kernel-route gradients differ"
    del again
    loss_p, plain16 = _lm_grads(torch, optim, lm, c16, params, batch,
                                use_pallas=False)
    p32 = _to_dtype(torch, params, torch.float32)
    loss_t, truth = _lm_grads(torch, optim, lm, c32, p32, batch,
                              use_pallas=False)
    cond = None
    if fp32_rel is None:
        cond = _f32_conditioning(torch, optim, lm, c32, p32, batch, truth)
        fp32_rel = LM_TRAIN_F32_NOISE * cond + LM_TRAIN_FP32_GRAD_REL
    errs = _grad_mean_errors(torch, optim, kern, plain16, truth)
    worst = _hold_grads(errs, f"lm train cut {arch}")
    # the check shown to reject a lost attention gradient: wq's zeroed, or
    # where bf16's own error on wq is as large as wq's gradient (the
    # reference's init puts attention near an argmax: h2o-danube at seq
    # 8192), the first of wk, wv, wo whose zeroing it rejects
    rejected = None
    for leaf in LM_TRAIN_ZEROED:
        wrong = optim.tree_map(lambda t: t, kern)
        wrong["blocks"][leaf] = torch.zeros_like(kern["blocks"][leaf])
        try:
            _hold_grads(_grad_mean_errors(torch, optim, wrong, plain16,
                                          truth), f"zeroed {leaf}")
        except AssertionError:
            rejected = leaf
            break
    if rejected is None:
        # bf16's own error is as large as every attention gradient (h2o-
        # danube at seq 8192): the fp32 rule below holds them, and it
        # rejects any zeroed leaf (its relative error is 1)
        assert fp32_rel < 1, (
            f"lm train cut {arch}: the bf16 check passes each of "
            f"{LM_TRAIN_ZEROED} zeroed, and the fp32 bound {fp32_rel:.3g} "
            "passes them too")
        rejected = "none in bf16; the fp32 rule"
    del kern, plain16, wrong

    # fp32 on the kernel route: 2 flash forwards a layer (the pass and its
    # recompute) and one backward, at the step's shapes in fp32
    flash.LAUNCHES.clear()
    flash.BWD_LAUNCHES.clear()
    bwd32 = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _recorded_bwd(flash, bwd32):
        loss_k32, kern32 = _lm_grads(torch, optim, lm, c32, p32, batch)
    torch.cuda.synchronize()
    wall32 = time.perf_counter() - t0
    launches32 = {"flash": {str(k): v for k, v in flash.LAUNCHES.items()},
                  "flash_bwd": {str(k): v
                                for k, v in flash.BWD_LAUNCHES.items()}}
    bwd_calls["fp32"] = _hold_bwd_calls(torch, flash, "float32", bwd32,
                                        f"lm train cut {arch}", fails)
    del bwd32
    want32 = {kind: {str(k): v for k, v in t.items()} for kind, t in
              train_flash_launches(c32, b, s, "float32", 1).items()}
    assert launches32 == want32, (arch, launches32, want32)
    rel32 = [float((g - t).abs().mean() / t.abs().mean().clamp_min(1e-30))
             for g, t in zip(optim.leaves(kern32), optim.leaves(truth))]
    worst32 = max(rel32)
    assert worst32 <= fp32_rel, (
        f"lm train cut {arch} fp32: leaf {rel32.index(worst32)} mean "
        f"error {worst32:.3g} of its mean > {fp32_rel}")
    out = {"arch": arch, "num_layers": n, "batch": b, "seq": s,
           "loss_kernel": float(loss_k), "loss_plain": float(loss_p),
           "loss_fp32": float(loss_t), "worst_grad_ratio": worst,
           "worst_call_ratio": worst_calls, "calls": len(calls),
           "repeat_bitwise": repeat, "bf16": {"launches": launches16},
           "bwd_calls": bwd_calls,
           "zeroed_rejected": rejected,
           "fp32": {"loss_kernel": float(loss_k32), "grad_seconds": wall32,
                    "leaf_rel_errors": rel32, "worst_leaf_rel": worst32,
                    "bound": fp32_rel, "conditioning": cond,
                    "launches": launches32}}
    say(f"[lm train] cut {arch} ({n} layers, batch {b}, seq {s}): losses "
        f"kernel {out['loss_kernel']:.6f} plain {out['loss_plain']:.6f} "
        f"fp32 {out['loss_fp32']:.6f}; {len(calls)} attention calls against"
        f" float64 (worst ratio to bound {worst_calls}); gradients' mean "
        f"error at most {worst:.3f} of the bound (a zeroed {rejected} "
        "gradient rejected); the kernel route's gradients repeat bit for "
        f"bit; backward kernel calls against float64 {bwd_calls} (worst "
        "ratio to bound; a dropped band rejected at each windowed call)")
    say(f"[lm train] cut {arch} fp32 on the kernel route: loss "
        f"{float(loss_k32):.6f}; launches {launches32}; gradient wall "
        f"{wall32:.4f}s; worst leaf mean error {worst32:.4g} of its mean "
        f"(bound {fp32_rel:.4g}"
        + (f": {LM_TRAIN_F32_NOISE} x the plain route's conditioning "
           f"{cond:.4g} + {LM_TRAIN_FP32_GRAD_REL})" if cond is not None
           else ")"))
    del params, p32, kern32, truth
    torch.cuda.empty_cache()
    return out


def lm_remat_run(torch, optim, lm, layers, flash, smi) -> dict:
    """(e): LM_REMAT_ARCH at full width, LM_REMAT's depth, the policy off
    and then LM_REMAT_POLICY, each from the same weights and batch: 1 cold and
    LM_REMAT["warm_steps"] warm steps of loss -> autograd ->
    clip_by_global_norm -> adam_update. The two runs' losses and gradient
    norms bit for bit; no attention route taken (the arch has none).
    Each step's peak is read twice: after the gradient (the policy's
    saved products live until the backward reaches their block) and
    after Adam's update."""
    from repro_torch.configs.base import get_config

    cfg = dataclasses.replace(get_config(LM_REMAT_ARCH),
                              num_layers=LM_REMAT["num_layers"])
    b, s = LM_REMAT["batch"], LM_REMAT["seq"]
    steps = 1 + LM_REMAT["warm_steps"]
    dev = LM_TRAIN_DEVICE
    batch = {"tokens": torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (b, s)), device=dev)}
    runs = {}
    for policy in (None, LM_REMAT_POLICY):
        torch.cuda.empty_cache()
        params = lm.init_params(
            cfg, torch.Generator(device=dev).manual_seed(2), dev)
        state = optim.adam_init(params)
        layers.ROUTES.clear()
        flash.LAUNCHES.clear()
        run = {"losses": [], "grad_norms": [], "step_seconds": [],
               "grad_peak_bytes": [], "step_peak_bytes": []}
        lm.set_remat_policy(policy)
        try:
            for _ in range(steps):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                loss, grads = _lm_grads(torch, optim, lm, cfg, params, batch)
                # the allocator counts on the host as work is queued
                run["grad_peak_bytes"].append(
                    torch.cuda.max_memory_allocated())
                clipped, norm = optim.clip_by_global_norm(grads,
                                                          LM_TRAIN_CLIP)
                del grads
                params, state = optim.adam_update(clipped, state, params,
                                                  lr=LM_TRAIN_LR)
                del clipped
                run["losses"].append(float(loss))  # the step has ended
                run["grad_norms"].append(float(norm))
                run["step_seconds"].append(time.perf_counter() - t0)
                run["step_peak_bytes"].append(
                    torch.cuda.max_memory_allocated())
        finally:
            lm.set_remat_policy(None)
        assert not layers.ROUTES and not flash.LAUNCHES, (
            layers.ROUTES, flash.LAUNCHES)
        del params, state
        run["warm_step_seconds"] = float(np.median(run["step_seconds"][1:]))
        run["grad_peak_bytes_max"] = max(run["grad_peak_bytes"])
        run["step_peak_bytes_max"] = max(run["step_peak_bytes"])
        runs[str(policy)] = run
    torch.cuda.empty_cache()
    off, on = runs["None"], runs[LM_REMAT_POLICY]
    assert all(math.isfinite(x) for x in off["losses"] + off["grad_norms"])
    ln_v = math.log(cfg.vocab_size)
    assert abs(off["losses"][0] - ln_v) < 2.0, (off["losses"][0], ln_v)
    same = (on["losses"] == off["losses"]
            and on["grad_norms"] == off["grad_norms"])
    assert same, ("remat policy: losses or gradient norms differ", off, on)
    width = 2 * cfg.ssm_inner + 2 * cfg.ssm_groups * cfg.ssm_state \
        + cfg.ssm_heads
    saved = cfg.num_layers * b * s * width * 2  # the kept products, bf16
    out = {"arch": LM_REMAT_ARCH, **LM_REMAT, "policy": LM_REMAT_POLICY,
           "num_layers": cfg.num_layers, "in_proj_width": width,
           "params": cfg.param_count(), "card": smi, "runs": runs,
           "kept_bytes": saved, "bitwise": same,
           "grad_peak_rise_bytes": (on["grad_peak_bytes_max"]
                                    - off["grad_peak_bytes_max"]),
           "step_peak_rise_bytes": (on["step_peak_bytes_max"]
                                    - off["step_peak_bytes_max"])}
    gib = 2.0 ** 30
    for name, run in runs.items():
        say(f"[lm train] (e) {LM_REMAT_ARCH} policy {name}: "
            f"{cfg.num_layers} layers, in-projection {width}, batch {b}, "
            f"seq {s}, bf16, remat: losses {run['losses']}, grad norms "
            f"{run['grad_norms']}; step seconds {run['step_seconds']}, "
            f"warm {run['warm_step_seconds']:.4f}s; gradient peak "
            f"{run['grad_peak_bytes_max'] / gib:.3f} GiB, step peak "
            f"{run['step_peak_bytes_max'] / gib:.3f} GiB; {smi}")
    say(f"[lm train] (e) {LM_REMAT_POLICY} against None: losses and "
        f"gradient norms bit for bit; gradient peak "
        f"{out['grad_peak_rise_bytes'] / gib:+.3f} GiB, step peak "
        f"{out['step_peak_rise_bytes'] / gib:+.3f} GiB (the kept products "
        f"{saved / gib:.3f} GiB); warm step {on['warm_step_seconds']:.4f}s "
        f"against {off['warm_step_seconds']:.4f}s; {smi}")
    return out


def _mm_counter(torch):
    """A dispatch mode counting the `aten.mm` calls made under it."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class MmCount(TorchDispatchMode):
        mm = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.aten.mm.default:
                self.mm += 1
            return func(*args, **(kwargs or {}))

    return MmCount()


def lm_remat_cut(torch, optim, lm, layers, flash) -> dict:
    """(f): LM_REMAT_CUT_ARCH at full width cut to LM_REMAT_CUT's depth,
    one step's gradients on the kernel route with the policy off and then
    on: every leaf bit for bit, the flash forward and backward launches
    counted from 0 for each and equal (under remat the forward runs twice
    a layer, its recompute included), and the backward one `aten.mm`
    short a block under the policy (every hymba block has an SSM)."""
    from repro_torch.configs.base import get_config

    full = get_config(LM_REMAT_CUT_ARCH)
    cfg = dataclasses.replace(full, num_layers=LM_REMAT_CUT["num_layers"])
    b, s, n = LM_REMAT_CUT["batch"], LM_REMAT_CUT["seq"], cfg.num_layers
    dev = LM_TRAIN_DEVICE
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(3),
                            dev)
    batch = {"tokens": torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (b, s)), device=dev)}
    want = train_flash_launches(cfg, b, s, "bfloat16", 1)
    got = {}
    for policy in (None, LM_REMAT_POLICY):
        flash.LAUNCHES.clear()
        flash.BWD_LAUNCHES.clear()
        layers.ROUTES.clear()
        count = _mm_counter(torch)
        lm.set_remat_policy(policy)
        try:
            loss, grads = _lm_grads(torch, optim, lm, cfg, params, batch,
                                    backward_mode=count)
        finally:
            lm.set_remat_policy(None)
        launches = {"flash": dict(flash.LAUNCHES),
                    "flash_bwd": dict(flash.BWD_LAUNCHES)}
        assert launches == want, (policy, launches, want)
        assert dict(layers.ROUTES) == {"flash": 2 * n}, layers.ROUTES
        got[str(policy)] = (loss, grads, launches, count.mm)
    off, on = got["None"], got[LM_REMAT_POLICY]
    same = torch.equal(off[0], on[0]) and all(
        torch.equal(x, y) for x, y in zip(optim.leaves(off[1]),
                                          optim.leaves(on[1])))
    assert same, "remat policy: hymba's cut gradients differ"
    assert off[2] == on[2], (off[2], on[2])
    assert off[3] - on[3] == n, ("backward mm", off[3], on[3])
    out = {"arch": LM_REMAT_CUT_ARCH, **LM_REMAT_CUT,
           "loss": float(off[0]), "bitwise": same,
           "launches": {k: {str(kk): v for kk, v in t.items()}
                        for k, t in off[2].items()},
           "backward_mm": {"None": off[3], LM_REMAT_POLICY: on[3]}}
    say(f"[lm train] (f) {LM_REMAT_CUT_ARCH} full width, {n} of "
        f"{full.num_layers} layers, "
        f"batch {b}, seq {s}, kernel route: loss {out['loss']:.6f}; policy "
        f"None and {LM_REMAT_POLICY}: every leaf bit for bit, launches "
        f"{off[2]} both; backward mm {off[3]} -> {on[3]}")
    del params, got, off, on
    torch.cuda.empty_cache()
    return out


def _flash_name(kernel, key, lse=False) -> str:
    """A flash kernel's name in the kernels line: a square causal shape
    by S (the name earlier runs gave it), another by Sq and Skv; the band
    and the lse store when on."""
    bh, sq, skv, d, dtype, causal, w = key
    span = f"S={sq}" if causal and sq == skv else f"Sq={sq},Skv={skv}"
    return (f"{kernel}[{dtype},BH={bh},{span},D={d},"
            f"{'causal' if causal else 'full'}"
            + (f",window={w}" if w else "") + (",lse]" if lse else "]"))


def _bwd_entry(key, row, launches) -> dict:
    name = _flash_name("flash_attention_bwd", key)
    return _attn_entry(name, "flash_attention_bwd.cu",
                       "src/repro/models/layers.py:218", launches,
                       row["max_abs_err"], row["ms"], row["plain_ms"],
                       row["bound_ms"], row["bound_by"], row["library_ms"])


def lm_train_fwd_entry(torch, flash, key, launches) -> dict:
    """The kernels line's entry of the forward at a training step's shape
    with the lse store on (the training path's forward)."""
    bh, sq, skv, d, dtype, causal, w = key
    q, k, v = _attn_inputs(torch, (bh, sq, d), (bh, skv, d),
                           getattr(torch, dtype), sq + d + 7)
    out, lse = flash.flash_attention(q, k, v, causal=causal, window=w,
                                     return_lse=True)
    plain_fwd = lambda: _by_heads(  # noqa: E731
        torch, flash.flash_attention_plain, (q, k, v), sq, skv,
        causal=causal, window=w, return_lse=True)
    plain, plain_lse = plain_fwd()
    _hold_attn(torch, f"flash lse {key}", out, plain, dtype,
               min(w, skv) if w else skv)
    assert float((lse - plain_lse).abs().max()) <= LSE_TOL[dtype], key
    err = _max_abs_err(torch, out, plain)
    del plain, plain_lse
    ms = _time_ms(torch, lambda: flash.flash_attention(
        q, k, v, causal=causal, window=w, return_lse=True), 10)
    plain_ms = _time_ms(torch, plain_fwd, 3)
    library_ms = _library(torch, _time_ms, _sdpa_call(
        torch, q[None], k[None], v[None], causal, w), 10)
    bound_ms, bound_by = _attn_bound(dtype, bh, sq, skv, d, causal=causal,
                                     window=w)
    entry = _attn_entry(
        _flash_name("flash_attention", key, lse=True), "flash_attention.cu",
        "src/repro/kernels/flash_attention.py:32", launches, err, ms,
        plain_ms, bound_ms, bound_by, library_ms)
    say(f"[lm train] {entry['name']}: launches {launches}, err "
        f"{entry['max_abs_err']:.3g}, ms {ms:.4f} plain {plain_ms:.4f} sdpa "
        f"{library_ms} bound {bound_ms:.4f} ({bound_by})")
    del q, k, v, out, lse
    torch.cuda.empty_cache()
    return entry


def phase_lm_train(torch, flash, smi) -> tuple[list, dict]:
    """Phase 17: LM training on the card. (a) the backward kernel at
    FLASH_BWD_SHAPES and the forward's lse store (`flash_bwd_checks`),
    and the forward with the band at FLASH_FWD_BAND_SHAPES
    (`band_fwd_rows`); (b) LM_TRAIN's steps of qwen3-4b at full width
    through `lm.loss_fn`, autograd, `optim.clip_by_global_norm` and
    `optim.adam_update`, the launches and routes counted; (c) the kernel
    route's gradients against the plain route's at the cut; (d) a step's
    gradients repeat bit for bit; (g) h2o-danube uncut (LM_TRAIN_UNCUT)
    and its cut; (h) hymba at train_4k (LM_TRAIN_4K); (e) the remat
    policy at mamba2-370m's full width, 12 of 48 layers (`lm_remat_run`);
    (f) the policy on hymba's kernel route at a cut (`lm_remat_cut`). Returns (the
    kernels line's entries, results)."""
    from repro_torch import optim
    from repro_torch.configs.base import get_config
    from repro_torch.models import layers, lm

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config(LM_TRAIN_ARCH),
                              num_layers=LM_TRAIN["num_layers"])
    rows, fwd = flash_bwd_checks(torch, flash)
    band_rows = band_fwd_rows(torch, flash)
    t_kernels = time.perf_counter() - t_phase
    results = {"arch": LM_TRAIN_ARCH, **LM_TRAIN, "lr": LM_TRAIN_LR,
               "clip": LM_TRAIN_CLIP, "card": smi,
               "flash_bwd": {str(k): r for k, r in rows.items()},
               "flash_fwd_lse": fwd,
               "flash_fwd_band": {str(k): r for k, r in band_rows.items()}}
    results["run"] = run = lm_train_run(torch, flash, optim, lm, layers, cfg,
                                        LM_TRAIN_ARCH, LM_TRAIN)
    fails = []
    results["cut"] = lm_train_cut(
        torch, optim, lm, layers, flash,
        dataclasses.replace(cfg, num_layers=LM_TRAIN_CUT_LAYERS),
        LM_TRAIN_ARCH, LM_TRAIN["batch"], LM_TRAIN["seq"], fails,
        LM_TRAIN_FP32_GRAD_REL)
    t_new = time.perf_counter()
    uncut = get_config(LM_TRAIN_UNCUT_ARCH)
    assert uncut.num_layers == LM_TRAIN_UNCUT["num_layers"], uncut
    results["uncut_run"] = lm_train_run(
        torch, flash, optim, lm, layers, uncut, LM_TRAIN_UNCUT_ARCH,
        LM_TRAIN_UNCUT, repeat=False)
    results["uncut_cut"] = lm_train_cut(
        torch, optim, lm, layers, flash,
        dataclasses.replace(uncut, num_layers=LM_TRAIN_CUT_LAYERS),
        LM_TRAIN_UNCUT_ARCH, LM_TRAIN_UNCUT["batch"], LM_TRAIN_UNCUT["seq"],
        fails)
    results["train_4k_cut"] = lm_train_cut(
        torch, optim, lm, layers, flash,
        dataclasses.replace(get_config(LM_TRAIN_4K_ARCH),
                            num_layers=LM_TRAIN_4K["num_layers"]),
        LM_TRAIN_4K_ARCH, LM_TRAIN_4K["batch"], LM_TRAIN_4K["seq"], fails)
    results["band_seconds"] = time.perf_counter() - t_new
    assert not fails, "phase 17: " + "; ".join(fails)
    t_remat = time.perf_counter()
    results["remat"] = lm_remat_run(torch, optim, lm, layers, flash, smi)
    results["remat_cut"] = lm_remat_cut(torch, optim, lm, layers, flash)
    results["remat_seconds"] = time.perf_counter() - t_remat
    # launches by key, each from its own run: the training runs' (bf16);
    # a key that no training run launches (fp32, hymba at train_4k) from
    # the cut whose kernel-route gradients launch it
    runs = [run["launches"], results["uncut_run"]["launches"]]
    cuts = [results[c][dt]["launches"] for c in ("cut", "uncut_cut",
                                                 "train_4k_cut")
            for dt in ("bf16", "fp32")]
    counted = runs + cuts

    def n_of(kind, key):
        return (sum(t[kind].get(str(key), 0) for t in runs)
                or sum(t[kind].get(str(key), 0) for t in cuts))

    entries = [_bwd_entry(k, r, n_of("flash_bwd", k))
               for k, r in rows.items()]
    for key in sorted({k for t in counted for k in t["flash"]}):
        key = ast.literal_eval(key)
        if key not in band_rows:
            entries.append(lm_train_fwd_entry(torch, flash, key,
                                              n_of("flash", key)))
    entries += [_attn_entry(
        _flash_name("flash_attention", k), "flash_attention.cu",
        "src/repro/kernels/flash_attention.py:32", n_of("flash", k),
        r["max_abs_err"], r["ms"], r["plain_ms"], r["bound_ms"],
        r["bound_by"], r["library_ms"]) for k, r in band_rows.items()]
    results["phase_seconds"] = time.perf_counter() - t_phase
    say(f"[lm train] phase 17 {results['phase_seconds']:.1f}s (kernel "
        f"checks {t_kernels:.1f}s, danube and hymba train_4k "
        f"{results['band_seconds']:.1f}s, remat policy "
        f"{results['remat_seconds']:.1f}s)")
    return entries, results


# --------------------------------------------------------------- profile
def _profiled(torch, fn, what: str) -> None:
    """Run `fn` once under torch.profiler; print device time by op and the
    device idle share (1 - summed kernel time / wall; one stream, so
    kernels do not overlap)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    avg = prof.key_averages()
    say(avg.table(sort_by="self_device_time_total", row_limit=20))
    # device-side events only (kernels, copies, sets): a CPU op's own
    # device time would count its kernels a second time
    busy_us = sum(e.self_device_time_total for e in avg
                  if e.device_type == DeviceType.CUDA)
    say(f"[profile] {what}: wall {wall * 1e3:.1f} ms, device busy "
        f"{busy_us / 1e3:.1f} ms, idle share {1 - busy_us / 1e6 / wall:.3f}")


def phase_profile(torch, gnn_serve, gnn_train) -> None:
    """`--profile`: the GAT main path's layer-wise pass, run again warm,
    then once under torch.profiler; then a GAT tiled full-batch training
    step at the training phase's widths, halo and then ring, each after two
    warm steps, once under the profiler; then a serial GAT tiled mini-batch step at phase 8's
    configuration, likewise. Prints warm seconds, device time by op, and
    each profiled run's device idle share."""
    with torch.inference_mode():
        out = gnn_serve.run(FULL_WIDTH + ["--requests", "1", "--model",
                                          "gat", "--agg-backend", "tiled"])
        eng = out.inference
        eng.run()
        say(f"[profile] warm layer seconds {eng.layer_times}")
        _profiled(torch, eng.run, "layer-wise pass")
    del out, eng
    expandable_segments(torch, gnn_train)
    for sync in ("halo", "ring"):
        run = gnn_train.run(TRAIN_WIDTH + ["--epochs", "2", "--model", "gat",
                                           "--agg-backend", "tiled",
                                           "--sync-mode", sync])
        _profiled(torch, run.trainer.train_step, f"{sync} training step")
        del run
        torch.cuda.empty_cache()
    mb = gnn_train.run(MB_WIDTH + ["--epochs", "0", "--model", "gat",
                                   "--agg-backend", "tiled"]).trainer
    try:
        for _ in range(2):
            sm = mb.train_step()
            say(f"[profile] warm-up mini-batch step: wall "
                f"{sm.step_wall_host:.4f}s, sample {sm.sample_time_host:.4f} "
                f"fetch {sm.fetch_time_host:.4f} transfer "
                f"{sm.transfer_time_host:.4f} compute "
                f"{sm.compute_time_host:.4f}")
        _profiled(torch, mb.train_step,
                  "mini-batch step (serial: host phases, then the device "
                  "step)")
    finally:
        mb.close()


# --------------------------------------------------------- aggregate host
def _always_function(torch, ops):
    """`ops.aggregate` as it would be if the tiled backends went through
    the autograd Function (`_TiledSum` / `_TiledMax`) also when no graph
    is recorded: the comparison of `--aggregate-host`."""
    aggregate = ops.aggregate

    def through_function(messages, dst, num_rows, *, edge_order=None,
                         local_dst=None, backend="scatter", reduce="sum",
                         **kw):
        if backend == "scatter":
            return aggregate(messages, dst, num_rows, backend=backend,
                             reduce=reduce, **kw)
        fn = ops._TiledMax if reduce == "max" else ops._TiledSum
        return fn.apply(messages, dst, edge_order, local_dst, num_rows,
                        kw.get("tile_v", 256),
                        kw.get("block_e", 128))[:num_rows]
    return through_function


def phase_aggregate_host(torch, ops, tiling, gnn_serve) -> None:
    """`--aggregate-host`: the host cost of the autograd Function
    (`_TiledSum` / `_TiledMax`) that `ops.aggregate` skips on the tiled
    backends when no graph is recorded, under inference_mode, as serving
    runs it. Per call: 2000 calls at a served MFG's shape (256
    rows, 300 edges; F 4 and 512) through `_always_function` and through
    `ops.aggregate` (which skips the Function when no graph is
    recorded), interleaved A B B A, host clock over the loop (the
    launches are queued, the card idles); then the GAT tiled serving run
    of phase 4 with every batch answered both ways, in alternating order
    (the host's speed drifts between runs), host compute a batch."""
    rng = np.random.default_rng(5)
    rows, e, calls = 256, 300, 2000
    dst = rng.integers(0, rows, e)
    order, ldst, _ = tiling.prepare_tiled_edges(dst, rows)
    dev = dict(device="cuda")
    d_dst = torch.as_tensor(dst, **dev)
    d_order = torch.as_tensor(order, dtype=torch.int64, **dev)
    d_ldst = torch.as_tensor(ldst, **dev)
    function = _always_function(torch, ops)
    for f in (4, 512):
        m = torch.randn(e, f, **dev)
        per = {"function": [], "direct": []}
        with torch.inference_mode():
            for name in ["function", "direct", "direct", "function"]:
                fn = function if name == "function" else ops.aggregate
                for _ in range(50):
                    fn(m, d_dst, rows, edge_order=d_order, local_dst=d_ldst,
                       backend="tiled")
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(calls):
                    fn(m, d_dst, rows, edge_order=d_order, local_dst=d_ldst,
                       backend="tiled")
                per[name].append((time.perf_counter() - t0) / calls * 1e6)
                torch.cuda.synchronize()
        say(f"[aggregate-host] F={f}: host us a call through the Function "
            f"{[round(t, 3) for t in per['function']]}, direct "
            f"{[round(t, 3) for t in per['direct']]}, difference of the "
            f"means {np.mean(per['function']) - np.mean(per['direct']):.3f}")
    # each served batch answered twice, once with each, in alternating
    # order; host compute is the engine's own clock (forward + sync)
    from repro_torch.serve.engine import ServeEngine
    answer, keep, pairs = ServeEngine.answer, ops.aggregate, []

    def paired(self, batch):
        order = (("function", "direct") if len(pairs) % 2 == 0
                 else ("direct", "function"))
        got = {}
        for name in order:
            ops.aggregate = function if name == "function" else keep
            got[name] = answer(self, batch)
        ops.aggregate = keep
        np.testing.assert_array_equal(got["function"][0], got["direct"][0])
        pairs.append((got["function"][2], got["direct"][2]))
        return got["direct"]

    ServeEngine.answer = paired
    try:
        with torch.inference_mode():
            gnn_serve.run(FULL_WIDTH + ["--model", "gat",
                                        "--agg-backend", "tiled"])
    finally:
        ServeEngine.answer, ops.aggregate = answer, keep
    t = np.asarray(pairs) * 1e3
    say(f"[aggregate-host] gat tiled serving, {len(t)} batches each "
        f"answered both ways: host compute p50 {np.median(t[:, 0]):.4f} "
        f"ms/batch through the Function, {np.median(t[:, 1]):.4f} direct; "
        f"per batch (Function - direct) median "
        f"{np.median(t[:, 0] - t[:, 1]):.4f} ms, quartiles "
        f"{np.percentile(t[:, 0] - t[:, 1], 25):.4f} / "
        f"{np.percentile(t[:, 0] - t[:, 1], 75):.4f}; logits equal")


# ------------------------------------------------------------------ main
def main() -> int:
    import torch

    if not torch.cuda.is_available():
        say("chip_smoke: no CUDA device is visible; this script runs the "
            "port on the card only")
        return 1
    if not (ROOT / "src" / "repro_torch" / "kernels").is_dir():
        say(f"chip_smoke: {ROOT / 'src' / 'repro_torch'} not found; run "
            "from the root of a checkout")
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import edge_partition as ep
    from repro_torch.core import graph as graph_mod
    from repro_torch.core import partition_book as book_mod
    from repro_torch.core.device import resolve_device
    from repro_torch.kernels import decode_attention as decode
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.kernels import ops
    from repro_torch.kernels import segment_spmm as spmm
    from repro_torch.kernels import tiling
    from repro_torch import optim
    from repro_torch.core import wire
    from repro_torch.core.vertex_partition import partition_vertices
    from repro_torch import obs
    from repro_torch.gnn import dist_jobs, fullbatch, minibatch, models
    from repro_torch.gnn import sync as sync_mod
    from repro_torch.kernels import ref
    from repro_torch.launch import gnn_serve, gnn_trace, gnn_train, ranks
    from repro_torch.core import cost_model, metrics, study
    from repro_torch.fault import FaultPlan
    from repro_torch.gnn import inference

    resolve_device("cuda")
    t_start = time.perf_counter()
    smi, kind = phase_device(torch)
    phase_build([spmm.LIBRARY, flash.LIBRARY, flash.BWD_LIBRARY,
                 decode.LIBRARY])
    say(f"[time] device + build {time.perf_counter() - t_start:.1f}s")
    if "--profile" in sys.argv[1:]:
        phase_profile(torch, gnn_serve, gnn_train)
        return 0
    if "--aggregate-host" in sys.argv[1:]:
        phase_aggregate_host(torch, ops, tiling, gnn_serve)
        return 0
    if "--dist" in sys.argv[1:]:
        phase_dist(torch, spmm, tiling, gnn_train, ep, fullbatch, models,
                   sync_mod, ranks, dist_jobs)
        return 0
    # the LM phases alone, in order: 6 (attention), 15 (families: danube
    # and hymba past its window), 17 (training: danube uncut, hymba at
    # train_4k)
    alone = [a for a in ("--attention", "--lm-families", "--lm-train")
             if a in sys.argv[1:]]
    if alone:
        if "--attention" in alone:
            phase_attention(torch, ops, flash, decode)
        if "--lm-families" in alone:
            phase_lm_families(torch, flash, decode, smi)
        if "--lm-train" in alone:
            phase_lm_train(torch, flash, smi)
        say(f"[done] {' '.join(alone)} {time.perf_counter() - t_start:.1f}s")
        return 0
    rows_out = phase_kernels(torch, spmm, tiling, graph_mod, ep, book_mod)
    say(f"[time] kernels {time.perf_counter() - t_start:.1f}s")
    STUDY_DIR.mkdir(exist_ok=True)
    launches, seen, serve_fp32 = phase_serve(torch, spmm, gnn_serve)
    say(f"[time] serve {time.perf_counter() - t_start:.1f}s")
    minibatch_shapes(torch, gnn_train, minibatch, partition_vertices, tiling,
                     seen)
    ring_shapes(torch, gnn_train, fullbatch, tiling, seen)
    elastic_rows = elastic_shapes(torch, gnn_train, fullbatch, tiling, seen)
    t_grid = time.perf_counter()
    study_cache = study_shapes(torch, study, inference, book_mod, tiling,
                               models, seen)
    t_grid = time.perf_counter() - t_grid
    say(f"[time] mini-batch, ring, elastic and study shapes "
        f"{time.perf_counter() - t_start:.1f}s (study {t_grid:.1f}s)")
    shapes = phase_shapes(torch, spmm, seen)
    say(f"[time] shapes {time.perf_counter() - t_start:.1f}s")
    seen.clear()
    attn_entries, attn_rows = phase_attention(torch, ops, flash, decode)
    say(f"[time] attention {time.perf_counter() - t_start:.1f}s")
    train, train_launches = phase_train(torch, spmm, ops, tiling, gnn_train,
                                        fullbatch, models, optim)
    say(f"[time] train {time.perf_counter() - t_start:.1f}s")
    train["minibatch"], mb_launches = phase_minibatch(
        torch, spmm, ref, tiling, gnn_train, minibatch, models, optim)
    say(f"[time] minibatch {time.perf_counter() - t_start:.1f}s")
    train["codecs"], codec_launches = phase_codecs(
        torch, spmm, tiling, gnn_train, gnn_serve, fullbatch, models, optim,
        wire, train, serve_fp32)
    say(f"[time] codecs {time.perf_counter() - t_start:.1f}s")
    train["robust"], robust_launches = phase_robust(
        torch, spmm, tiling, gnn_train, gnn_serve, models, optim, train,
        elastic_rows)
    say(f"[time] robust {time.perf_counter() - t_start:.1f}s")
    train["trace"], trace_launches = phase_trace(
        torch, spmm, tiling, gnn_train, gnn_serve, gnn_trace, obs, fullbatch,
        models, optim, train)
    say(f"[time] trace {time.perf_counter() - t_start:.1f}s")
    train["study"], study_launches = phase_study(
        torch, spmm, study, obs, models, gnn_train, gnn_serve, cost_model,
        metrics, FaultPlan, study_cache)
    train["study"]["shapes_seconds"] = t_grid
    say(f"[time] study {time.perf_counter() - t_start:.1f}s")
    train["lint"], train["study"]["examples_seconds"] = phase_lint()
    say(f"[time] lint {time.perf_counter() - t_start:.1f}s")
    lm_entries, train["lm"] = phase_lm(torch, flash, decode, smi)
    say(f"[time] lm {time.perf_counter() - t_start:.1f}s")
    family_entries, train["lm_families"] = phase_lm_families(
        torch, flash, decode, smi)
    say(f"[time] lm families {time.perf_counter() - t_start:.1f}s")
    train["dist"], dist_launches, dist_rows = phase_dist(
        torch, spmm, tiling, gnn_train, ep, fullbatch, models, sync_mod,
        ranks, dist_jobs)
    say(f"[time] dist {time.perf_counter() - t_start:.1f}s")
    train_entries, train["lm_train"] = phase_lm_train(torch, flash, smi)
    say(f"[time] lm train {time.perf_counter() - t_start:.1f}s")
    shapes.update(dist_rows)
    for run, n in {**train_launches, **mb_launches, **codec_launches,
                   **robust_launches, **trace_launches,
                   **study_launches, **dist_launches}.items():
        assert set(n) <= set(shapes), (
            f"{run} launched the kernel at shapes phase 5 did not time: "
            f"{sorted(set(n) - set(shapes))}")
    launches.update(train_launches)
    launches.update(mb_launches)
    launches.update(codec_launches)
    launches.update(robust_launches)
    launches.update(trace_launches)
    launches.update(study_launches)
    launches.update(dist_launches)

    kernels = []
    for (combiner, rows, f), row in shapes.items():
        by_run = {m: n.get((combiner, rows, f), 0) for m, n in launches.items()}
        kernels.append({
            "name": f"segment_reduce_{combiner}[rows={rows},F={f}]",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/segment_reduce.cu",
            "replaces": "src/repro/kernels/segment_spmm.py:59",
            # launches at this shape over the GAT and SAGE tiled serving,
            # full-batch and mini-batch training runs, with and without a
            # lossy codec, crashed, resumed, retried, rescaled or failed
            # over, traced, or in the study grid
            "launches": sum(by_run.values()),
            "launches_by_run": by_run,
            "E_tiled": row["E_tiled"],
            "real_edges": row["real_edges"],
            "max_abs_err": row["max_abs_err"],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
        })
    kernels += attn_entries + lm_entries + family_entries + train_entries
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_kernels.json").write_text(
        json.dumps(rows_out + list(shapes.values()) + attn_rows, indent=1)
        + "\n")
    (out_dir / "chip_smoke_train.json").write_text(
        json.dumps(train, indent=1) + "\n")
    say(f"[done] {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
