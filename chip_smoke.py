#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`efficient_tts_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py [--baseline DIR]

Phases, each of which raises on failure:
  1. device: needs torch.cuda; prints `nvidia-smi` name and power limit;
  2. build: compiles `efficient_tts_tpu_torch/csrc/*.cu` with nvcc, and
     reads the MRF library's SASS (cuobjdump): wgmma (HGMMA) and TMA
     (UTMALDG) instructions, and no mma.sync (HMMA); the flash library's
     SASS function by function: the forward (every head width, one and two
     consumer warpgroups) holds HGMMA and UTMALDG and no HMMA, the
     backward's dkv and dq kernels HGMMA and no HMMA; and the W8A8
     library's conv kernels (every width): integer wgmma (IGMMA) and
     UTMALDG, and no integer mma.sync (IMMA); the probe library's two
     kernels: HGMMA (bf16) and IGMMA (int8), UTMALDG, no HMMA or IMMA;
  3. kernel vs plain version: every MRF stage of the V1 generator (C =
     256/128/64/32 at its main-path length for B=16, T2=512) through the
     Hopper kernel and through `mrf_stage_reference`, on the same bf16
     inputs; the flash attention forward at the EFTS-Transformer's shapes
     ([16, 4, 512, 96] without segment ids, [16, 4, 128, 96] with ragged
     ones; in training [64, 4, 512, 96] and [64, 4, 128, 96] with ragged
     ones) against `flash_attention_reference`, on the same f32 inputs;
     the flash attention backward (dq, dk, dv through `FlashAttention`:
     one forward, one dkv and one dq launch) at the training shapes
     ([64, 4, 512, 96] without and with ragged segment ids, [64, 4, 128,
     96] with them) against `torch.autograd.grad` through
     `flash_attention_reference`; the f32 MRF kernel at the four V1 stage
     shapes (3xTF32 products) against `mrf_stage_reference` (f32, TF32
     off); the W8A8 MRF
     kernel bit for bit against `mrf_stage_int8_reference` at [16, 65536,
     64], [16, 131072, 32] and the bench's [16, 262144, 32], with dynamic
     and with static activation scales; the matmul probe at [2^20, 128]
     and at row counts that end in a partial 64-row tile (16, 48, 80,
     2^20 + 16) against `probe_matmul_reference`, int8 bit for bit, bf16
     within relative RMS 1e-2;
  4. main paths at full width, seeded random weights through the weight
     bridge; the launch counts are set to 0 before each path and read after
     it:
     a. EFTS-CNN with 76 symbols: `synthesize` on a few ragged batches and
        `synthesize_fixed` at T2=512, bf16, into HiFi-GAN V1; checks shapes,
        lengths, finiteness, the MRF launch counts, and one wav against the
        same path with the plain MRF version;
     b. EFTS-Transformer at `lj_efts_transformer_phnseq.yaml`'s widths
        with attn_impl="flash": `synthesize` on 3 ragged batches at T1=128
        with bucket_multiple=128 (every attention call eligible) and
        `synthesize_fixed` at T2=512, bf16; the same checks, 8 flash
        launches per synthesis, and one wav against the same path with
        the plain attention version;
     c. EFTS-Transformer training at the yaml's widths with dropout 0.0 and
        attn_impl="flash", f32, the yaml's batch of 64 at T1=128, T2=512
        with ragged lengths, the yaml's Adam + WarmupLR: the first step's
        gradients leaf by leaf against the same model with
        attn_impl="flash_plain", then 10 steps of `make_train_step` on each,
        losses and grad_norm step by step; 10 forward, 10 dkv and 10 dq
        launches per step (4 text-encoder calls at T=128, 2 mel-encoder and
        4 decoder calls at T=512, all with segment ids);
     d. the published yaml (dropout 0.1): 3 steps with an explicit
        generator; finite losses and no flash launch at all;
     e. f32 synthesis, the default compute_dtype=None: `synthesize` on the
        ragged batches and `synthesize_fixed` at T2=512 with default
        arguments, for EFTS-CNN and for EFTS-Transformer; 72 launches of
        the f32 MRF kernel per synthesis, and the wav against the same path
        with `mrf_impl="plain"` (relative RMS <= 1e-4, max <= 1e-3);
     f. the benchmarks' entry points: `bench.mrf_fused.main` (K1, the W8A8
        kernel with dynamic and static scales, and the cuDNN bf16 stage at
        [16, 262144, 32]) and `bench.probe_int8.main` (the probe in bf16 and
        int8 beside the library's chains), once each;
     g. narrow generators: EFTS-CNN `synthesize_fixed` at T2=512 into a
        V2-width HiFi-GAN (128 initial channels, stages 64/32/16/8) and into
        the narrow one of the serving tests (32, stages 16/8/4/2), bf16 and
        f32: the stages below 32 channels or between multiples of 32 run
        the MRF kernels at the next multiple of 32 (launch counts by the
        width the kernel ran at), and the wav against the same path with
        `mrf_impl="plain"` within the MRF bounds of 4a and 4e;
     h. streaming at full width: one EFTS-CNN batch's mels (B=16, T2=512)
        from `decode_mel_fixed`, in f32 and bf16, through
        `generator_chunked` (chunk 256, overlap 24) and one utterance
        through `stream_vocoder` (chunk 64, overlap 24), each against the
        full pass (f32 within 1e-5, bf16 within the MRF bound of 4a), with
        the MRF launches of each window, the time to the first chunk and
        the full pass's; then each MRF stage (bf16 and f32 kernels) on a
        streamed window against the full stage: the rows past the stage's
        halo bit-equal;
     i. `synthesize_dispatch` with the fetch one batch late: 4 ragged
        EFTS-CNN batches, f32 and bf16, each fetched waveform equal to
        `synthesize_fixed`'s at its bucket; the `timings` splits, the wait
        in `fetch`, the loop's time and its idle share;
     j. ResBlock2: EFTS-CNN `synthesize_fixed` at T2=512 into a generator
        at HiFi-GAN V3's widths (plain convs, no MRF launch), f32 and bf16,
        its time and the vocoder's, finite output;
     k. serving: `serve.TTSEngine` around EFTS-CNN at bench.py's widths with
        148 symbols (durations pinned as in `bench/serving_load.py`) and
        HiFi-GAN V1, f32 and bf16, max_batch 16: the warmup timed; 32 mixed
        texts through `engine.synthesize` bit-equal to `pipeline.synthesize`
        on the same padded micro-batches, within the MRF bounds of its
        plain-MRF run, its pcm16 transfer within one PCM step of the f32
        one; `make_http_server` on 127.0.0.1:0 answering 32 `/synthesize`
        requests from 8 client threads, each WAV within the MRF bounds of the
        engine's waveform for its text; `/synthesize_stream` twice (the
        first meets the stream's shapes cold; the second's time to its
        headers, sent with the first chunk, and to its end) against the
        batch waveform; the time of one micro-batch of 16 at the middle
        sentence's bucket; an EFTS-Transformer engine (text and mel buckets
        multiples of 128, bf16) with its attention on the flash kernel,
        equal to `pipeline.synthesize`; and `bin.inference` on a checkpoint
        of the served model (config.yml as JSON text), its wavs' PCM equal
        to `pipeline.synthesize`'s;
     l. the load bench (`bench/serving_load.py:run_load`) through each warm
        engine of 4k: Poisson arrivals at 4, 16 and 64 QPS and at the rate
        one f32 micro-batch of 16 sustains, 10 s each, queue bound 256,
        deadline 2 s: p50/p95/p99 (null when all were shed), shed counts,
        mean batch, audio-s/s, per-batch phases and p99 over the batch
        time; then 4 s at 16 QPS under torch.profiler for the device's
        idle share;
     m. training on a corpus: EFTS-CNN at `configs/lj_efts_cnn_char.yaml`'s
        widths (148 symbols, 512 channels, 5/3/6 res-conv layers) from seeded
        weights through `compat` (`trainable=True`): the first step's loss
        and every gradient leaf on the card against the same step on the
        CPU, f32, a ragged batch of 4; a seeded synthetic corpus
        (`bench/corpus.py`: 384 train and 16 dev utterances of 1.5-10 s,
        PCM_16 at 22050 Hz) in a temporary directory; `bin.train` on the
        char yaml (`--set` for the wav path, the mel memory cache and the
        steps and intervals): 12 steps at B=128 (3 batches an epoch) with
        finite losses, checkpoints at 6 and 12, `config.yml` and evals at 6
        and 12, then `--resume` to step 14; `bin.inference` on
        checkpoint-14steps, 8 utterances in one batch, its PCM equal to
        `pipeline.synthesize` on the folded model and 72 f32 MRF launches;
        the EFTS-Transformer's yaml through the same CLI (dropout 0, text
        and mel buckets of 128, char input, 148 symbols) for 4 steps at
        B=64, 10 forward, 10 dkv and 10 dq flash launches a step; then the
        EFTS-CNN step at B=128 on the middle of the corpus's three
        length-sorted batches (CUDA events, median of 10 after 2 warmup
        calls; its T1 and T2), its profile (busy, idle share, top kernels,
        launches a step), its peak memory, and the CLI run's step wall and
        data wait in the first epoch (mel extraction, by the native or the
        numpy path) and in the cached epochs; after it, the flash forward,
        dkv and dq at every other length the CLI ran ([64, 4, T, 96] with
        ragged ids; T = 256, 640, 768, 896 on this corpus) against
        `flash_attention_reference` and its autograd, as in phase 3;
     n. vocoder training on 4m's corpus: HiFi-GAN V1 with the MPD and the
        MSD from seeded weights (`init.init_gan_state`): the first GAN step
        on the card against the same step on the CPU, f32, B=2 crops of
        8192 samples (every metric, each side's gradient and each leaf by
        relative L2 from the first Adam moment, the spectral norm's u and
        v; `GAN_CARD_TOL`); `bin.train_vocoder` at B=16, f32, with an EMA
        of 0.999 and the dev set: 10 steps with finite losses, evals at 5
        and 10 (72 f32 MRF launches each), a checkpoint, then `--resume` to
        12; 3 steps with `--compute_dtype bfloat16`; `bin.extract_gta` on
        4m's EFTS-CNN checkpoint (one mel per train utterance, its frame
        count) and 2 steps of `--fine_tuning --base_mels_path`;
        `bin.inference` on 4m's checkpoint and the trained vocoder (its
        EMA folded: PCM equal to `pipeline.synthesize`, 72 f32 MRF
        launches), the eval step's waveform through the f32 kernel against
        `mrf_impl="plain"` at `F32_WAV_TOL`, and `bin.serve`'s engine on
        both checkpoints in bf16 (18 bf16 MRF launches a stage); then the
        GAN step at B=16, segment 8192, f32 and bf16 (CUDA events, median
        of 10 after 2 warmup calls, its profile, launches and peak memory)
        beside the CLI run's step wall and data wait (4n's CLI runs take the
        host data path, `--device_corpus off`);
     o. the vocoder corpus held on the card (`data/device_corpus.py`) on
        4m's corpus at V1, B=16, segment 8192: its bytes against
        `corpus_nbytes`, the load and upload times, the crops' step
        determinism and bounds, a device batch against `batch_from_positions`
        on the CPU from the same positions (audio bit-equal, mels within
        `DEVICE_BATCH_MEL_TOL`), the batch's time; `bin.train_vocoder
        --device_corpus on`, f32 with an EMA, 6 steps, an eval at 6 (72 f32
        MRF launches), checkpoints at 4 and 6, peak memory, then a resume from
        4 whose crops equal the uninterrupted run's; `on` with `--fine_tuning`
        raises; 6 bf16 steps under `auto`, which takes the device path; each
        run's step wall and data wait beside 4n's host-path runs; the
        device-path GAN step timed and profiled in f32 and bf16; the
        EFTS-Transformer at its yaml's widths under AdamW + CosineAnnealingLR:
        the first update on the card against the CPU's (B=2), then
        `bin.train` with that optimizer, 2 steps and a resume to 3 (10
        forward, dkv and dq flash launches a step); the DurationModel at the
        JAX package's defaults with a speaker table: the first step on the
        card against the CPU's, a 50-step fit whose loss halves, rounded
        durations from `inference`, one step timed and profiled;
     p. the reference's file formats on 4m's and 4n's checkpoints:
        `bin.export_torch` of the EFTS-CNN checkpoint to the reference's
        .pkl and `bin.convert_checkpoint` back (its config.yml copied
        beside), parameters bit-equal; `bin.inference` on it with 4n's
        vocoder, and with the EMA generator exported to reference generator
        files (weight-normed, and folded with `--fold_weight_norm`): each
        run's wavs byte-equal to 4n-iv's, 72 f32 MRF launches a run; the
        `g_`/`do_` pair of `--model HiFiGANFull`, its MPD and MSD read back
        through `compat.torch_import` onto the card: logits and feature maps
        bit-equal to the checkpoint's discriminators on a batch of 16 dev
        segments (pairwise and fused), the spectral norm's u and v equal;
        `utils.profiling.time_step` of the f32 EFTS-CNN `synthesize_fixed`
        of 5 (printed there beside its CUDA-event time, within 10%) and a
        `trace` of one call naming the f32 MRF kernel; 4m's eval images, or
        a line saying that matplotlib is absent;
     q. multi-rank synthesis and serving, each rank a process of this script
        (`--rank_task`) that loads the kernels built above, all on the one
        card (NCCL refuses two ranks on one device): i. a world of one under
        NCCL, mesh (1, 1): `synthesize_fixed_sharded` in dp, tp, sp, dp+tp
        and dp+sp and `synthesize(mesh=)` on 4a's ragged batches, f32 and
        bf16, each bit-equal to one card with 4a's MRF launches; ii. two
        ranks under gloo on CUDA tensors: dp (2, 1), sp (1, 2) and tp (1, 2)
        in f32 against one card's `synthesize_fixed` (dp bit-equal on each
        rank's block of rows, sp bit-equal, tp and dp's whole batch within
        JAX's atol 2e-5, rtol 1e-4), each rank's K3 launches (72 under dp
        and sp, 0 under tp) and peak memory, tp's sharded parameter bytes
        (half of one card's); the EFTS-Transformer under dp (bf16, flash):
        4 + 4 forward launches a rank, bit-equal on each rank's block;
        `TTSEngine(mesh=)` on 3 texts against one rank's engine (atol 5e-5);
        iii. `bin.serve --data_parallel 2` (gloo, both ranks on card 0) on a
        checkpoint of the pinned EFTS-CNN: 4 HTTP requests from rank 0, each
        within one PCM step of the one-card server's engine, then SIGTERM,
        both ranks exiting 0;
     r. training over ranks, each rank a process of this script, all on the
        one card: i. a world of one under NCCL, mesh (1, 1): EFTS-CNN (dp,
        tp, sp; B=16), the EFTS-Transformer (dp, tp; B=8, flash) and the
        HiFi-GAN V1 GAN step (dp, tp; B=2), each step bit-equal to one
        card's; ii. two ranks under gloo at published widths: EFTS-CNN at
        B=128 (dp (2, 1), tp (1, 2), sp (1, 2)), the EFTS-Transformer at
        B=64, T1=128, T2=512 (dp, tp; K4's forward, dkv and dq launches
        counted on each rank) and the GAN at B=16, segment 8192 (dp, tp),
        and four ranks, each model in dp+tp (2, 2); each step held to one
        card's on rank 0 with the CPU tests' bounds (metrics rtol 1e-5;
        first moments and updates, see `MRT_TOL`; the transformer's, whose
        K4 calls round to TF32, with 4c's), the ranks' gathered states
        equal (sha256), each rank's peak memory;
        iii. `bin.train` (EFTS-CNN, the char yaml's widths, batch 8) and
        `bin.train_vocoder` (V1, batch 4, host path, an eval on rank 0
        through K3) over two ranks, 2 steps each: equal parameters on both
        ranks, then rank 0's checkpoints resumed on this card for a third
        step;
  5. timing with CUDA events (median and quartiles of 20 runs after
     warmup): each path's `synthesize_fixed`, the training step with the
     kernels, with the plain attention and with dropout 0.1, their device
     time by kernel and idle share from torch.profiler, and each MRF stage
     kernel beside its bound (f32: under the 3xTF32 peak and, for the
     record, FP32's), its plain version and the 18 cuDNN convs of the
     stage, in bf16 and in f32; the f32 `synthesize_fixed` of both
     models; the W8A8 kernel beside K1 and the cuDNN bf16 stage at the
     bench's shape, and its plain version; the probe beside its plain
     version and the library's chains, and its int8:bf16 rate ratio. The flash kernels at
     their shapes (and at the CLI's other lengths, a row each), their plain versions and `F.scaled_dot_product_attention`
     (forward, and its backward for the backward kernels) are timed by
     their device time (torch.profiler, 20 calls), since one call's
     CUDA-event time there is mostly the host's launch time, which is
     printed beside it: each kernel's row is its own device time per launch
     the profile recorded (the profiler records a varying share of a
     window's launches, at times none of a kernel's: such a window is
     profiled again, up to 3 times; the forward then takes the time of
     CUDA events around calls queued behind a sleep kernel, which its line
     always gives, beside the per-call sum over every kernel of the window,
     the earlier reading, and the kernels it holds); bounds from
     `efficient_tts_tpu_torch/utils/roofline.py`;
  5b. with `--baseline DIR`, where DIR holds an earlier tree's
     `flash_attention.cu`, `mrf_stage_int8.cu` (one whose W8A8 conv takes
     the weight's tensor map, `mrf_int8_weight_map`) and `probe_matmul.cu`
     with their headers: all built with the same nvcc flags, then the flash forward (device time per launch,
     queued-event time and host time per call) at the four forward shapes,
     the W8A8 stage (CUDA events) at the bench's shape, dynamic and static,
     and the matmul probe (CUDA events) in bf16 and int8 at [2^20, 128],
     timed in turns (earlier, this tree, this tree, earlier), the outputs
     compared;
  6. a `{"kernels": [...]}` line, then the card line, then the last line
     `{"ok": true, "device": {...}}`.
Imports nothing of JAX or of the JAX package.
"""

import contextlib
import dataclasses
import json
import math
import os
import shutil
import sys
import time

import numpy as np

B, T1, T2 = 16, 96, 512
T1_TR = 128  # the transformer's text length: a multiple of 128, so its text encoder runs the kernel
N_TIMED = 20
# Kernel vs plain version: the same bf16 rounding points, but f32 sums of up to
# 11*256 terms taken in another order flip a bf16 rounding now and then, and
# each flip carries down the chain of 6 convs (measured at C=256 on an H100:
# max 2^-6.7 of the range, relative RMS 2.5e-3).
STAGE_TOL = {"max_abs_over_range": 2**-5, "rel_rms": 1e-2}
# whole waveform, kernel vs plain MRF stages on the same weights
WAV_TOL = {"max_abs_over_range": 0.05, "rel_rms": 1e-2}
# f32 MRF kernel vs plain version (cuDNN, TF32 off): no rounding but the f32
# sums' order; plain TF32 (about 4e-4 relative a conv) would fail it
F32_STAGE_TOL = {"max_abs_over_range": 5e-4, "rel_rms": 5e-5}
# f32 waveform, MRF kernel vs plain MRF stages: absolute max (the wav lies in
# [-1, 1]) and relative RMS
F32_WAV_TOL = {"max_abs": 1e-3, "rel_rms": 1e-4}
# the matmul probe's bf16 mode vs its plain version (f32 sums in another
# order, then 8 bf16 roundings); its int8 mode and the W8A8 stage must be
# bit-equal to theirs
PROBE_BF16_TOL = {"rel_rms": 1e-2}
# the W8A8 stage's shapes: two V1 stages and bench/mrf_fused.py's
INT8_SHAPES = ((64, 65536), (32, 131072), (32, 262144))
# Flash kernel vs plain version: the kernel rounds q, k, v and the softmax
# weights to TF32 (2^-11 relative), the plain version is f32; on N(0, 1)
# inputs that leaves errors near 1e-3 of the output range.
FLASH_TOL = {"max_abs_over_range": 1e-2, "rel_rms": 2e-3}
# whole waveform, flash kernel vs plain attention on the same weights: the
# TF32 rounding of 8 attention layers reaches the mel, which the bf16
# vocoder then rounds; the bound is the MRF one
TR_WAV_TOL = WAV_TOL
# Backward kernels vs plain gradients: q, k, v, do, p and ds rounded to
# TF32; ds = (dp - di) p cancels, so the error is a few times the forward's
# (predicted near 1e-3 relative RMS, PERF.md).
BWD_TOL = {"max_abs_over_range": 2e-2, "rel_rms": 5e-3}
# Training, kernel path vs flash_plain path from the same params and batch:
# the 10 attention layers' TF32 rounding reaches every gradient. A leaf
# passes when its error norm is within 2e-2 of its gradient's norm plus
# 1e-5 of the whole gradient's norm (the key biases' true gradient is 0:
# the softmax is shift-invariant, so they hold only rounding).
TRAIN_TOL = {"loss_rel": 1e-3, "grad_norm_rel": 1e-3, "leaf_rel": 2e-2, "leaf_abs_of_global": 1e-5}
TRAIN_B, TRAIN_T2, N_TRAIN_STEPS = 64, 512, 10
# lj_efts_transformer_phnseq.yaml's optimizer, scheduler and grad_norm blocks
YAML_OPTIMIZER = {
    "optimizer_type": "Adam",
    "optimizer_params": {"lr": 1.0e-3, "betas": [0.9, 0.99], "eps": 1.0e-9, "weight_decay": 1.0e-5, "amsgrad": True},
    "grad_norm": 1.0,
    "scheduler_type": "WarmupLR",
    "scheduler_params": {"warmup_steps": 4000},
}
# the MRF kernels' names (csrc/mrf_stage.cu), as the profiler reports them
MRF_KERNELS = {"bf16": "mrf_conv_wgmma_bf16_kernel", "f32": "mrf_conv_wgmma_tf32x3_kernel"}
# the flash kernels' names (csrc/flash_attention.cu), as the profiler and
# cuobjdump report them, and their instantiations (head widths 32-128; the
# forward also with one and two consumer warpgroups)
FLASH_KERNELS = {"fwd": "flash_fwd_kernel", "dkv": "flash_bwd_dkv_wgmma_kernel", "dq": "flash_bwd_dq_wgmma_kernel"}
FLASH_FUNCTIONS = {"fwd": 8, "dkv": 4, "dq": 4}
# the W8A8 conv kernel (csrc/mrf_stage_int8.cu), one instantiation per C = 32..256
INT8_KERNEL, INT8_FUNCTIONS = "mrf_conv_int8_wgmma_kernel", 8
# the matmul probe's kernel (csrc/probe_matmul.cu), bf16 and int8
PROBE_KERNEL = "probe_wgmma_kernel"
# row counts of the probe's partial-tile check (64-row tiles): below one
# tile, one and a part, and one past the bench's 2^20
PROBE_PARTIAL_M = (16, 48, 80, (1 << 20) + 16)
# the sources an earlier tree gives to --baseline
BASELINE_SOURCES = ("flash_attention", "mrf_stage_int8", "probe_matmul")
# the flash forward's shapes: synthesis at B=16 (decoder, text encoder) and
# the training batch (every call masked)
FLASH_FWD_SHAPES = (("decoder", B, 512, False), ("text_encoder", B, 128, True),
                    ("t512_training", TRAIN_B, 512, True), ("text_encoder_training", TRAIN_B, 128, True))
# (Tq, Tk) of the transformer's mel-side attention on a sequence-parallel
# rank (`utils/roofline.py:SP_FLASH_SHAPES`): T2 = 512 over 2 and 4 ranks,
# and 640 over 4, whose 160 rows the kernels take padded to 192
SP_FLASH_SHAPES = ((256, 512), (128, 512), (160, 640))
# chunked and streamed f32 waveforms vs the full pass: the interiors' MRF
# rows are bit-equal, but cuDNN may sum conv_pre, the upsamples and
# conv_post in another order at a window's shape (the wav lies in [-1, 1])
CHUNK_F32_ATOL = 1e-5
# HiFi-GAN widths below V1's: the V2 generator's and the serving tests' narrow one
NARROW_VOCODERS = {"hifigan_v2": 128, "hifigan_narrow": 32}
# the serving engine's micro-batch (bin/serve.py's default) and the load
# bench's arms: offered rates (plus the rate one f32 batch of 16 at t2 = 512
# sustains), seconds each, and the profiled arm's seconds
SERVE_MAX_BATCH = 16
LOAD_QPS, LOAD_SECONDS, PROFILED_SECONDS = (4.0, 16.0, 64.0), 10.0, 4.0
# the HTTP stream's f32 PCM against the engine's pcm16 batch waveform: the
# stream truncates to PCM16 (one step), the batch rounds (half a step), and
# the decode at max_t2 sums in another order than at the batch's bucket
STREAM_F32_ATOL = 1.5 / 32767 + CHUNK_F32_ATOL
# 4m: EFTS-CNN's first step on the card against the CPU, f32 (cuDNN and
# cuBLAS with TF32 off): the loss, and each gradient leaf within 1e-4 of its
# own largest magnitude plus 1e-7 of the tree's largest (the CPU tests' bound
# against JAX)
CNN_CPU_TOL = {"loss_rel": 1e-4, "leaf_of_own_max": 1e-4, "leaf_of_tree_max": 1e-7}
# the synthetic corpus: utterances and the mel memory cache (MB) that holds
# the train set's mels, about 70 MB
CORPUS_TRAIN, CORPUS_DEV, CORPUS_MEL_CACHE_MB = 384, 16, 128
# 4n: the first GAN step on the card against the CPU, f32 (TF32 off) at V1,
# B=2: every metric within the CPU tests' 1e-5 relative; each side's whole
# gradient (from the first Adam moment) within 1e-4 relative in L2 and each
# leaf within 5e-3 relative in L2; u and v within 1e-5 absolute. The CPU
# tests' leafwise bounds (1e-4 and 1e-3 of a leaf's max) do not carry over:
# every product sums in another order on the card, and a leaky ReLU whose
# activation lies within rounding of 0 flips its slope; in the MPD's last
# layers (about 100 positions a segment) one flip moves a weight-gradient
# row by about 1/400. Measured on an H100 (PERF.md, PR 11): metrics 1.4e-6,
# whole gradients 2.1e-5 (G) and 4.4e-5 (D), the worst leaf 9.6e-4 in L2
# (6.5e-3 of its max), u and v 1.2e-6 (one f32 mat-vec of up to 2624 terms
# summed in another order); the card against itself 1.4e-6 of a leaf's max
GAN_CARD_TOL = {"metric_rel": 1e-5, "grad_rel_l2": 1e-4, "leaf_rel_l2": 5e-3, "uv_abs": 1e-5}
# the vocoder CLI's batch and the GAN step's timed batch (HiFi-GAN V1's segment)
GAN_B = 16
# 4o: the device batch on the card against `batch_from_positions` on the CPU
# from the same crop positions: the audio bit-equal, each mel within 1e-5 of
# its largest magnitude (the CPU tests' bound on the tensor log-mel against JAX)
DEVICE_BATCH_MEL_TOL = 1e-5
# 4o-iii: a non-Adam pairing of the registry for the EFTS-Transformer's yaml
REGISTRY_OPTIMIZER = {"optimizer_type": "AdamW", "scheduler_type": "CosineAnnealingLR",
                      "scheduler_params": {"T_max": 1000}}
# 4o-iii/iv: a first update on the card against the CPU's: each gradient leaf
# (from the first moment) within TRAIN_TOL's bounds, and the update, Adam's
# about -lr * sign(g), within 1e-3 relative where the CPU's gradient is at
# least 5% of its leaf's largest (nearer 0 the sign may flip under rounding),
# in leaves whose gradient is at least 1e-3 of the whole's norm (an attention
# key's bias has a true gradient of 0: the softmax is shift-invariant)
UPDATE_TOL = {"grad_leaf_rel_l2": 2e-2, "grad_abs_of_global": 1e-5, "update_rel": 1e-3, "above_of_leaf_max": 5e-2,
              "leaf_above_of_global": 1e-3}
# 4o-iv: the DurationModel's batch, its length and the fit's steps
DUR_B, DUR_T, DUR_STEPS = 16, 256, 50


# the card's name and power limit, stamped on every phase line once known
CARD = {}


def log(obj):
    print(json.dumps({**obj, **CARD} if "phase" in obj else obj), flush=True)


def err_stats(out, ref):
    err = (out.float() - ref.float()).abs()
    return {
        "max_abs_err": float(err.max()),
        "range": float(ref.float().abs().max()),
        "rel_rms": float((err.square().mean() / ref.float().square().mean().clamp_min(1e-30)).sqrt()),
    }


def within(stats, tol):
    return (stats["max_abs_err"] <= tol["max_abs_over_range"] * stats["range"]
            and stats["rel_rms"] <= tol["rel_rms"])


def device_profile(torch, fn, n=3):
    """Device time by kernel name per run of `fn`, from torch.profiler's
    CUDA activity; an empty dict when the profiler saw no device time. The
    first records of a profiled window can be lost (1-3 kernels of a
    window in a fresh process, about 30 after many windows, among them the
    training step's first flash forward), so a warm-up step of the
    profiler's schedule, one call of `fn`, takes that loss before the n
    calls it keeps."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=n, repeat=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        prof.step()
    kernels = {}
    for evt in prof.key_averages():
        # the schedule's step annotation spans the whole window on the device
        if evt.device_type != DeviceType.CUDA or evt.key.startswith("ProfilerStep"):
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        kernels[evt.key] = (us / 1e3 / n, evt.count / n)
    return kernels


def device_ms(torch, fn, n=N_TIMED):
    """Device time of one call of `fn`, summed over its kernels (torch.profiler,
    `n` calls), or None when the profiler saw no device time. Unlike the
    CUDA-event time of a single call, it leaves out the host's launch time."""
    prof = device_profile(torch, fn, n)
    return sum(v[0] for v in prof.values()) if prof else None


def host_us(torch, fn, n=50):
    """Host time to issue one call of `fn` (no synchronisation inside), in us."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def launch_ms(torch, fn, names, n=N_TIMED, tries=3):
    """Device time per launch of each kernel whose name holds one of
    `names`, over the launches torch.profiler recorded in `n` calls of
    `fn`: {name: (ms per launch, launches recorded per call)}. The profiler
    here records a varying share of a window's launches (at times none of
    a kernel's), so a window that misses a kernel is profiled again, up to
    `tries` windows; a kernel never seen is left out."""
    out = {}
    for _ in range(tries):
        prof = device_profile(torch, fn, n)
        for name in names:
            named = [v_ for key, v_ in prof.items() if name in key]
            seen = sum(v_[1] for v_ in named)
            if name not in out and seen > 0:
                out[name] = (sum(v_[0] for v_ in named) / seen, seen)
        if len(out) == len(names):
            break
    return out


def queued_ms(torch, fn, n=N_TIMED):
    """Device time per call of `fn` from CUDA events around `n` calls queued
    behind a 10 ms sleep kernel: the device runs them back to back, however
    long the host takes to issue them (each must launch one kernel and
    issue in well under 0.5 ms)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


SASS_OPS = ("HGMMA", "IGMMA", "UTMALDG", "HMMA", "IMMA", "FFMA")


def read_sass(path):
    """A built library's SASS, as cuobjdump -sass prints it."""
    import shutil
    import subprocess

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return subprocess.run([tool, "-sass", str(path)], capture_output=True, text=True, check=True).stdout


def op_counts(sass):
    """Counts of the wgmma (HGMMA; IGMMA for 8-bit integers), TMA load
    (UTMALDG), mma.sync (HMMA; IMMA for integers) and FFMA instructions in
    SASS text."""
    import re

    return {op: len(re.findall(rf"\b{op}\b", sass)) for op in SASS_OPS}


def sass_by_function(path):
    """{mangled function name: `op_counts` of its SASS} of a built library."""
    return {part.split("\n", 1)[0].strip(): op_counts(part) for part in read_sass(path).split("Function :")[1:]}


def stage_inputs(torch, c, t, seed, dev, kernel_sizes, dilation_sizes, dtype=None):
    """Seeded activations and unit-gain weights (std 1/sqrt(k*C)), so every
    conv of the chain moves the output; bf16 unless `dtype` says otherwise."""
    from efficient_tts_tpu_torch.ops.mrf import conv_order

    dtype = dtype or torch.bfloat16
    g = torch.Generator().manual_seed(seed)
    order = conv_order(kernel_sizes, dilation_sizes)
    ws = [(torch.randn((k, c, c), generator=g) / (k * c) ** 0.5).to(dev, dtype) for k, _ in order]
    bs = (0.1 * torch.randn((len(order), c), generator=g)).to(dev)
    x = torch.randn((B, t, c), generator=g).to(dev, dtype)
    return x, ws, bs, order


def stage_bound_ms(c, t, order, kind="bf16"):
    """The stage's bound: "bf16" (K1), "tf32x3" (K3 f32: f32 values, a third
    of the TF32 peak), "fp32" (the same work at FP32's peak, the bound of
    the earlier FFMA kernel) or "int8" (K2: bf16 activations, int8 weights with
    f32 scales)."""
    from efficient_tts_tpu_torch.utils.roofline import bound_ms, mrf_stage_work

    act, wb, vecs = {"bf16": (2, 2, 1), "tf32x3": (4, 4, 1), "fp32": (4, 4, 1), "int8": (2, 1, 2)}[kind]
    ops, nbytes = mrf_stage_work(B, t, c, [k for k, _ in order], act_bytes=act, weight_bytes=wb, per_conv_vectors=vecs)
    return (*bound_ms(ops, nbytes, kind), ops)


def cudnn_convs(torch, x, ws, bs, order):
    """The stage's 18 convolutions alone, through F.conv1d (cuDNN), on
    [B, C, T] copies of the inputs in their dtype: a yardstick of speed."""
    import torch.nn.functional as F

    x_ncw = x.transpose(1, 2).contiguous()
    w_ncw = [w.permute(1, 2, 0).contiguous() for w in ws]
    b = bs.to(x.dtype)

    def run():
        for i, (k, d) in enumerate(order):
            F.conv1d(x_ncw, w_ncw[i], b[i], padding=(k - 1) // 2 * d, dilation=d)

    return run


def flash_inputs(torch, t, seed, dev, segmented, b=B, n=3, tk=None):
    """Seeded N(0, 1) q, k, v (and with n=4 an upstream gradient do) as the
    [B, H, T, 96] views of [B, T, H, 96] tensors that the q/k/v linears
    give; ragged segment ids (valid 1, pad 0) with one row all valid, as the
    text encoder's key-padding mask gives. With `tk` (segmented), q and do
    are the last sequence-parallel rank's t rows of a sequence of tk keys, as
    `nn/attention.py:attend` hands them to the kernels: the rows' ids are
    theirs of the keys', and rows up to the next multiple of 64 are zero
    queries of id -1 (no key's) with a zero gradient."""
    import torch.nn.functional as F

    from efficient_tts_tpu_torch.ops.flash_attention import SegmentIds

    g = torch.Generator().manual_seed(seed)
    if tk is None:
        xs = [torch.randn((b, t, 4, 96), generator=g).to(dev).transpose(1, 2) for _ in range(n)]
        seg = None
        if segmented:
            lengths = torch.randint(t // 2, t + 1, (b,), generator=g)
            lengths[0] = t
            ids = (torch.arange(t)[None, :] < lengths[:, None]).to(torch.int32).to(dev)
            seg = SegmentIds(ids, ids)
        return (*xs, seg)
    pad = -t % 64
    xs = [torch.randn((b, t if i in (0, 3) else tk, 4, 96), generator=g) for i in range(n)]
    xs = [F.pad(x, (0, 0, 0, 0, 0, pad)) if i in (0, 3) else x for i, x in enumerate(xs)]
    lengths = torch.randint(tk // 2, tk + 1, (b,), generator=g)
    lengths[0] = tk
    kv = (torch.arange(tk)[None, :] < lengths[:, None]).to(torch.int32)
    q_ids = F.pad(kv[:, tk - t:], (0, pad), value=-1)
    seg = SegmentIds(q_ids.contiguous().to(dev), kv.to(dev))
    return (*(x.to(dev).transpose(1, 2) for x in xs), seg)


def check_flash_backward(torch, fa, t, segmented, dev, bwd_rows, tk=None):
    """One training call of the flash kernels at [64, 4, t, 96] (forward with
    residuals, dkv, dq) against `flash_attention_reference` and its autograd:
    dq, dk and dv at BWD_TOL, one launch of each kernel. With `tk`, a
    sequence-parallel rank's t rows (padded to a multiple of 64) against tk
    keys (`flash_inputs`). Puts each backward kernel's errors into
    bwd_rows[kernel, Tq, Tk, segmented] (the kernels' lengths) and returns
    the forward output's errors, against the plain output."""
    q, k, v, do, seg = flash_inputs(torch, t, seed=t + 1 + (tk or 0), dev=dev, segmented=segmented, b=TRAIN_B,
                                    n=4, tk=tk)
    tq, tk = q.shape[2], k.shape[2]
    xs = [x.detach().requires_grad_(True) for x in (q, k, v)]
    fa.reset_launches()
    out = fa.flash_attention(*xs, seg, sm_scale=96**-0.5)
    got = torch.autograd.grad(out, xs, do)
    torch.cuda.synchronize()
    if fa.launches != {(kernel, tq, tk, segmented): 1 for kernel in ("fwd", "dkv", "dq")}:
        raise AssertionError(f"one backward launched {fa.launches}")
    ref_xs = [x.detach().requires_grad_(True) for x in (q, k, v)]
    ref_out = fa.flash_attention_reference(*ref_xs, seg, sm_scale=96**-0.5)
    ref = torch.autograd.grad(ref_out, ref_xs, do)
    fwd = err_stats(out.detach(), ref_out.detach())
    stats = {name: err_stats(g_, r_) for name, g_, r_ in zip(("dq", "dk", "dv"), got, ref)}
    log({"phase": "kernel_vs_plain", "kernel": "flash_attention_backward", "shape": list(q.shape), "keys": tk,
         "rows": t, "segment_ids": segmented, "forward": fwd, **stats, "tolerance": BWD_TOL,
         "forward_tolerance": FLASH_TOL})
    if not within(fwd, FLASH_TOL):
        raise AssertionError(f"flash forward disagrees with its plain version at {tuple(q.shape)}: {fwd}")
    for name, st in stats.items():
        if not within(st, BWD_TOL):
            raise AssertionError(f"flash backward {name} disagrees with the plain gradient at {tuple(q.shape)}: {st}")
    for kernel, names in (("dkv", ("dk", "dv")), ("dq", ("dq",))):
        bwd_rows[kernel, tq, tk, segmented] = {
            "max_abs_err": max(stats[n]["max_abs_err"] for n in names),
            "rel_rms": max(stats[n]["rel_rms"] for n in names),
            "max_abs_over_range": max(stats[n]["max_abs_err"] / stats[n]["range"] for n in names)}
    return {"max_abs_err": fwd["max_abs_err"], "rel_rms": fwd["rel_rms"]}


def flash_bound_ms(q, k, seg, rows=None):
    """Each of q, k, v, o moved once (and the two id arrays), against the two
    products at the TF32 tensor-core peak (the kernel's operand precision);
    `rows`: the query rows the function needs (a padded q's real ones)."""
    from efficient_tts_tpu_torch.utils.roofline import bound_ms, flash_work

    b, h, tq, dk = q.shape
    ops, nbytes = flash_work(b, h, rows or tq, k.shape[2], dk, seg is not None)
    return (*bound_ms(ops, nbytes, "tf32"), ops)


def flash_bwd_bound_ms(q, k, seg, part, rows=None):
    """q, k, v, do, m, l, di (and the id arrays) read once, the part's
    gradients written once, against its products at the TF32 peak."""
    from efficient_tts_tpu_torch.utils.roofline import bound_ms, flash_backward_work

    b, h, tq, dk = q.shape
    ops, nbytes = flash_backward_work(b, h, rows or tq, k.shape[2], dk, part, seg is not None)
    return (*bound_ms(ops, nbytes, "tf32"), ops)


def plain_bwd_part(torch, fa, part, q, k, v, o, m, l, do, seg, scale):
    """The plain version of one backward kernel from the same residuals:
    (dk, dv) for "dkv", dq for "dq" (the arithmetic of
    `flash_attention_bwd_reference`, cut to what that kernel writes)."""
    p = torch.exp(fa._logits(q, k, seg, scale) - m[..., None]) / l[..., None]
    dp = torch.einsum("bhqc,bhkc->bhqk", do, v)
    ds = (dp - torch.sum(o * do, dim=-1)[..., None]) * p * scale
    if part == "dq":
        return torch.einsum("bhqk,bhkc->bhqc", ds, k)
    return torch.einsum("bhqk,bhqc->bhkc", ds, q), torch.einsum("bhqk,bhqc->bhkc", p, do)


def profile_summary(prof, ms, names):
    """Busy time, idle share against the CUDA-event time `ms`, the time and
    launches of the kernels whose names hold each of `names`, and the top 10."""
    busy = sum(v[0] for v in prof.values())
    top = sorted(prof.items(), key=lambda kv: -kv[1][0])[:10]
    out = {"device_busy_ms": busy, "idle_share": max(0.0, 1.0 - busy / ms),
           "kernel_launches": sum(v[1] for v in prof.values()),
           "top": [[k[:90], v[0], v[1]] for k, v in top]}
    for n in names:
        out[n + "_ms"] = sum(v[0] for k, v in prof.items() if n in k)
        out[n + "_launches"] = sum(v[1] for k, v in prof.items() if n in k)
    return out


def flash_by_segments(launches, kernel="fwd"):
    """{segmented: launches} of one flash kernel, summed over lengths."""
    out = {}
    for (name, _, _, seg), n in launches.items():
        if name == kernel:
            out[seg] = out.get(seg, 0) + n
    return out


def train_batch(rng, num_symbols, odim, t2=TRAIN_T2):
    """The yaml's batch of 64 at T1=128, T2=512 (or `t2`): ragged text and
    mel lengths (one utterance of each at full length), seeded ids and
    N(0, 1) mel targets, zero past each length."""
    tl = rng.integers(T1_TR // 2, T1_TR + 1, TRAIN_B).astype(np.int32)
    ml = rng.integers(t2 // 2, t2 + 1, TRAIN_B).astype(np.int32)
    tl[0], ml[0] = T1_TR, t2
    text = np.zeros((TRAIN_B, T1_TR), np.int32)
    for i, n in enumerate(tl):
        text[i, :n] = rng.integers(1, num_symbols, n)
    mel = rng.standard_normal((TRAIN_B, t2, odim)).astype(np.float32)
    mel *= np.arange(t2)[None, :, None] < ml[:, None, None]
    return {"text": text, "text_lengths": tl, "mel": mel, "mel_lengths": ml}


def ragged_batches(rng, t1, num_symbols, n=3):
    batches = []
    for _ in range(n):
        lengths = rng.integers(t1 // 2, t1 + 1, B).astype(np.int32)
        lengths[0] = t1
        text = np.zeros((B, t1), np.int32)
        for i, n_tok in enumerate(lengths):
            text[i, :n_tok] = rng.integers(1, num_symbols, n_tok)
        batches.append((text, lengths))
    return batches


def check_synthesize(pipeline, model, batches, results, hop, multiple):
    """Shapes, finiteness, bucket, lengths from the stage-1 readback and a
    silent tail, for each `synthesize` result."""
    for (text, lengths), (wav, wl) in zip(batches, results):
        mel_len = pipeline.predict_lengths(model, text, lengths).cpu().numpy()
        t2 = wav.shape[1] // hop
        if wav.shape != (B, t2 * hop) or t2 % multiple or not np.all(np.isfinite(wav)):
            raise AssertionError(f"synthesize gave wav {wav.shape}, finite={np.isfinite(wav).all()}")
        if not np.array_equal(wl, np.clip(mel_len, 1, t2) * hop):
            raise AssertionError(f"wav_lengths {wl} do not follow the stage-1 readback {mel_len}")
        if any(np.any(wav[i, n:] != 0) for i, n in enumerate(wl)):
            raise AssertionError("waveform tail beyond wav_lengths is not silent")


def keyed(launches):
    """A launch-count dict with tuple keys, for a JSON line."""
    return {"/".join(map(str, k)) if isinstance(k, tuple) else k: n for k, n in launches.items()}


def wall_ms(torch, fn, n=5):
    """Median host time of `fn` (which ends in a host copy or a
    synchronisation) in ms, after one warmup call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def mrf_halo(kernel_sizes, dilation_sizes):
    """Rows on each side that reach an MRF stage's output position: the
    widest branch's sum of (k-1)/2 * (d + 1) over its dilation units."""
    return max(sum((k - 1) // 2 * (d + 1) for d in dils) for k, dils in zip(kernel_sizes, dilation_sizes))


def stage_launches(stages, dname, n):
    return {(dname, c): 18 * n for c, _ in stages}


def check_fixed(torch, wav, mel, t2, hop, odim):
    if (wav.shape != (B, t2 * hop) or mel.shape != (B, t2, odim)
            or not bool(torch.isfinite(wav).all()) or not bool(torch.isfinite(mel).all())):
        raise AssertionError(f"synthesize_fixed gave wav {tuple(wav.shape)} mel {tuple(mel.shape)}")


def engine_reference(pipeline, engine, texts, cdt):
    """The waveforms `engine.synthesize(texts)` must give: its micro-batches
    (max_batch texts in order, padded as `_dispatch_batch` pads them) through
    `pipeline.synthesize` with the engine's arguments, trimmed and scaled as
    `_fetch_batch` does."""
    from efficient_tts_tpu_torch.utils.masks import bucket_length

    out = []
    for lo in range(0, len(texts), engine.max_batch):
        seqs = [engine.encode(t) for t in texts[lo: lo + engine.max_batch]]
        bb = engine.batch_bucket(len(seqs))
        t1 = min(bucket_length(max(len(x) for x in seqs), engine.t1_multiple), engine.max_t1)
        text = np.zeros((bb, t1), np.int32)
        lengths = np.ones((bb,), np.int32)
        for i, x in enumerate(seqs):
            text[i, : len(x)], lengths[i] = x, len(x)
        wav, wl = pipeline.synthesize(engine.model, engine.vocoder, text, lengths, bucket_multiple=engine.t2_multiple,
                                      max_t2=engine.max_t2, compute_dtype=cdt, output="pcm16")
        out += [wav[i, : int(wl[i])].astype(np.float32) / 32767.0 for i in range(len(seqs))]
    return out


def wav_within(torch, got, want, cdt):
    """err_stats of two lists of waveforms (joined) and whether they are
    within the MRF bound of their dtype (F32_WAV_TOL or WAV_TOL)."""
    stats = err_stats(torch.from_numpy(np.concatenate(got)), torch.from_numpy(np.concatenate(want)))
    if cdt is None:
        return stats, stats["max_abs_err"] <= F32_WAV_TOL["max_abs"] and stats["rel_rms"] <= F32_WAV_TOL["rel_rms"]
    return stats, within(stats, WAV_TOL)


def http_post(port, path, text, timeout=300):
    """(status, body, seconds to the response's headers, seconds to its end)
    of one POST to the server on 127.0.0.1:port."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        t0 = time.perf_counter()
        conn.request("POST", path, json.dumps({"text": text}).encode(), {"Content-Type": "application/json"})
        resp = conn.getresponse()
        t_head = time.perf_counter() - t0
        body = resp.read()
        return resp.status, body, t_head, time.perf_counter() - t0
    finally:
        conn.close()


def wav_pcm(body):
    import io
    import wave

    with wave.open(io.BytesIO(body)) as w:
        return np.frombuffer(w.readframes(w.getnframes()), "<i2")


def serving_phase(torch, voc, stages, new_launches, serve_flash):
    """4k: the serving engine on the card, f32 and bf16; returns the load
    bench's arms' inputs: {dname: (engine, batch_ms)}."""
    import threading

    from efficient_tts_tpu_torch import compat, init, pipeline
    from efficient_tts_tpu_torch import serve as serving
    from efficient_tts_tpu_torch.bench import serving_load, time_ms
    from efficient_tts_tpu_torch.models.efficient_tts_transformer import EftsTransformerConfig
    from efficient_tts_tpu_torch.ops import flash_attention as fa
    from efficient_tts_tpu_torch.ops import mrf

    bf16 = torch.bfloat16
    s_cfg, s_params = serving_load.pinned_efts_params()
    model = compat.efts_cnn_from_jax(s_params, s_cfg, device="cuda")
    texts = [serving_load.SENTENCES[i % 3] for i in range(2 * SERVE_MAX_BATCH)]
    hop = voc.cfg.hop_size
    out = {}
    for cdt, dname in ((None, "f32"), (bf16, "bf16")):
        engine = serving.TTSEngine(model, voc, max_batch=SERVE_MAX_BATCH, compute_dtype=cdt)
        t0 = time.perf_counter()
        serving_load.warm(engine, SERVE_MAX_BATCH)
        warm_s = time.perf_counter() - t0
        # the main path: 2 x max_batch mixed texts through the engine
        mrf.reset_launches()
        got = engine.synthesize(texts)
        launches = new_launches["serve_engine", dname] = dict(mrf.launches)
        want = engine_reference(pipeline, engine, texts, cdt)
        equal = all(g.shape == w.shape and np.array_equal(g, w) for g, w in zip(got, want))
        lengths = [len(w) for w in got]
        plain = serving.TTSEngine(model, voc, max_batch=SERVE_MAX_BATCH, compute_dtype=cdt, mrf_impl="plain")
        got_plain = plain.synthesize(texts)
        plain_stats, plain_ok = wav_within(torch, got, got_plain, cdt)
        f32_out = serving.TTSEngine(model, voc, max_batch=SERVE_MAX_BATCH, compute_dtype=cdt, pcm16_transfer=False)
        got_f32 = f32_out.synthesize(texts)
        pcm_err = max(float(np.abs(g - w).max()) for g, w in zip(got, got_f32))
        # one micro-batch of max_batch utterances at t2 = 512 (the middle
        # sentence), the batch time the load bench's arms are held against
        mid = engine.encode(serving_load.SENTENCES[1])
        t1 = -(-len(mid) // engine.t1_multiple) * engine.t1_multiple
        text16 = np.zeros((SERVE_MAX_BATCH, t1), np.int32)
        text16[:, : len(mid)] = mid
        len16 = np.full((SERVE_MAX_BATCH,), len(mid), np.int32)
        t2_mid = int(pipeline.predict_lengths(model, text16, len16).max())
        t2_mid = -(-t2_mid // engine.t2_multiple) * engine.t2_multiple
        batch = time_ms(lambda: pipeline.synthesize_fixed(model, voc, text16, len16, t2_mid, compute_dtype=cdt,
                                                          output="pcm16"), iters=10)
        expected = stage_launches(stages, dname, 2)
        log({"phase": "main_path", "what": "serve.TTSEngine.synthesize", "dtype": dname, "texts": len(texts),
             "max_batch": SERVE_MAX_BATCH, "warmup_s": warm_s, "mrf_launches": keyed(launches),
             "expected": keyed(expected), "wav_seconds": [n / voc.cfg.sampling_rate for n in lengths[:3]],
             "equal_to_pipeline_synthesize": equal, "vs_plain_mrf": plain_stats,
             "plain_tolerance": WAV_TOL if cdt is not None else F32_WAV_TOL, "pcm16_vs_f32_transfer_max": pcm_err,
             "pcm16_tolerance": 1 / 32767, "batch_t2": t2_mid, "batch_ms": batch["median"],
             "batch_ms_p25": batch["p25"], "batch_ms_p75": batch["p75"],
             "sustained_qps": SERVE_MAX_BATCH / (batch["median"] / 1e3)})
        if launches != expected:
            raise AssertionError(f"the engine in {dname} launched MRF {launches}, expected {expected}")
        if not equal:
            raise AssertionError(f"the engine in {dname} differs from pipeline.synthesize on its micro-batches")
        if [len(w) for w in got_plain] != lengths or not plain_ok:
            raise AssertionError(f"the engine in {dname} disagrees with its plain-MRF run: {plain_stats}")
        if pcm_err > 1 / 32767:
            raise AssertionError(f"the pcm16 engine in {dname} is {pcm_err * 32767} steps from the f32 one")
        del plain, f32_out, got_plain, got_f32

        # the HTTP server: 8 client threads, 4 requests each, /synthesize
        ref = dict(zip(texts, got))
        server = serving.make_http_server(engine, host="127.0.0.1", port=0)
        port = server.server_address[1]
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        results, errors = [], []
        try:
            mrf.reset_launches()

            def client(k):
                try:
                    for j in range(4):
                        text = serving_load.SENTENCES[(k + j) % 3]
                        code, body, _, secs = http_post(port, "/synthesize", text)
                        results.append((text, code, body, secs))
                except Exception as e:  # noqa: BLE001
                    errors.append(repr(e))

            t0 = time.perf_counter()
            clients = [threading.Thread(target=client, args=(k,)) for k in range(8)]
            for c in clients:
                c.start()
            for c in clients:
                c.join(300)
            http_s = time.perf_counter() - t0
            http_launches = new_launches["serve_http", dname] = dict(mrf.launches)
            # one stream: the time to its response headers (sent once the first
            # chunk is ready) and to its end, against the batch waveform. The
            # warmup covers the batch grid only, so the first stream meets the
            # decode at max_t2 and the windows' shapes cold; the second is timed
            stream_text = serving_load.SENTENCES[2]
            _, _, cold_first_s, cold_whole_s = http_post(port, "/synthesize_stream", stream_text)
            mrf.reset_launches()
            code_s, raw, first_s, whole_s = http_post(port, "/synthesize_stream", stream_text)
            stream_launches = new_launches["serve_stream", dname] = dict(mrf.launches)
            stats_http = json.loads(http_get(port, "/stats"))
        finally:
            server.shutdown()
            server.batcher.close()
            server.server_close()
            thread.join(10)
        if errors or len(results) != 32 or any(code != 200 for _, code, _, _ in results):
            raise AssertionError(f"HTTP /synthesize in {dname}: {errors or [r[1] for r in results]}")
        served = [wav_pcm(body).astype(np.float32) / 32767.0 for _, _, body, _ in results]
        direct = [ref[text] for text, _, _, _ in results]
        if [len(a) for a in served] != [len(b) for b in direct]:
            raise AssertionError(f"HTTP /synthesize in {dname}: lengths differ from the engine's")
        http_stats, http_ok = wav_within(torch, served, direct, cdt)
        lat = sorted(secs for _, _, _, secs in results)
        n_batches = http_launches.get((dname, stages[0][0]), 0) // 18
        log({"phase": "main_path", "what": "serve.make_http_server /synthesize", "dtype": dname, "clients": 8,
             "requests": len(results), "seconds": http_s, "latency_ms_p50": 1e3 * lat[len(lat) // 2],
             "latency_ms_max": 1e3 * lat[-1], "mrf_launches": keyed(http_launches), "batches": n_batches,
             "vs_engine": http_stats, "tolerance": WAV_TOL if cdt is not None else F32_WAV_TOL,
             "stats": stats_http})
        if not http_ok or not n_batches or http_launches != stage_launches(stages, dname, n_batches):
            raise AssertionError(f"HTTP /synthesize in {dname}: {http_stats}, launches {http_launches}")
        if code_s != 200:
            raise AssertionError(f"HTTP /synthesize_stream in {dname} gave {code_s}")
        streamed = np.frombuffer(raw, "<i2").astype(np.float32) / 32767.0
        batch_wav = ref[stream_text]
        # the last frames differ: the stream's last window ends at the true
        # edge, the batch pads its mel with zeros to the bucket
        n = len(batch_wav) - 20 * hop
        s_stats = err_stats(torch.from_numpy(streamed[:n]), torch.from_numpy(batch_wav[:n]))
        s_ok = (s_stats["max_abs_err"] <= STREAM_F32_ATOL if cdt is None else within(s_stats, WAV_TOL))
        n_win = stream_launches.get((dname, stages[0][0]), 0) // 18
        log({"phase": "main_path_vs_batch", "what": "serve /synthesize_stream", "dtype": dname,
             "samples": len(streamed), "batch_samples": len(batch_wav), "compared_samples": n, **s_stats,
             "tolerance": {"max_abs": STREAM_F32_ATOL} if cdt is None else WAV_TOL, "first_chunk_ms": 1e3 * first_s,
             "whole_stream_ms": 1e3 * whole_s, "cold_first_chunk_ms": 1e3 * cold_first_s,
             "cold_whole_stream_ms": 1e3 * cold_whole_s, "windows": n_win, "mrf_launches": keyed(stream_launches)})
        if len(streamed) != len(batch_wav) or not s_ok or not n_win or stream_launches != stage_launches(
                stages, dname, n_win):
            raise AssertionError(f"the stream in {dname} disagrees with the batch waveform: {s_stats}, "
                                 f"launches {stream_launches}")
        out[dname] = (engine, batch["median"])

    # an EFTS-Transformer behind the engine: its attention on the flash
    # kernel (text and mel buckets multiples of 128), bf16
    tr_cfg = EftsTransformerConfig(num_symbols=148, dropout_rate=0.0, sigma=0.01, attn_impl="flash")
    tr_params = init.init_efts_transformer(2, tr_cfg)
    tr_params["duration_predictor"]["out"]["b"][:] = 1.3
    tr = compat.efts_transformer_from_jax(tr_params, tr_cfg, device="cuda")
    tr_engine = serving.TTSEngine(tr, voc, max_batch=SERVE_MAX_BATCH, t1_multiple=128, t2_multiple=128,
                                  compute_dtype=bf16)
    tr_texts = texts[:SERVE_MAX_BATCH]
    fa.reset_launches()
    mrf.reset_launches()
    got = tr_engine.synthesize(tr_texts)
    serve_flash.update(flash_by_segments(fa.launches))
    tr_mrf = dict(mrf.launches)
    want = engine_reference(pipeline, tr_engine, tr_texts, bf16)
    equal = all(np.array_equal(g, w) for g, w in zip(got, want))
    expected_flash = {True: tr_cfg.n_text_encoder_layer, False: tr_cfg.n_decoder_layer}
    log({"phase": "main_path", "what": "serve.TTSEngine.synthesize, EFTS-Transformer", "dtype": "bf16",
         "texts": len(tr_texts), "flash_launches": {str(k): v for k, v in serve_flash.items()},
         "flash_expected": {str(k): v for k, v in expected_flash.items()}, "mrf_launches": keyed(tr_mrf),
         "equal_to_pipeline_synthesize": equal})
    if serve_flash != expected_flash or tr_mrf != stage_launches(stages, "bf16", 1) or not equal:
        raise AssertionError(f"the transformer engine launched flash {serve_flash}, MRF {tr_mrf}, equal={equal}")
    return out


def inference_cli_phase(torch, voc, stages, new_launches):
    """4k, the inference CLI: a checkpoint of the served EFTS-CNN with its
    config.yml written as JSON text (which YAML readers take too), the
    sentences synthesized twice (--repeats 2) with the CLI's random V1
    vocoder (the weights of `voc`), each written wav's PCM against
    `pipeline.synthesize` on the same batch."""
    import dataclasses
    import tempfile

    from scipy.io import wavfile

    from efficient_tts_tpu_torch import compat, pipeline
    from efficient_tts_tpu_torch.bench import serving_load
    from efficient_tts_tpu_torch.bin import inference
    from efficient_tts_tpu_torch.ops import mrf
    from efficient_tts_tpu_torch.text import text_to_sequence
    from efficient_tts_tpu_torch.train.checkpoint import save_checkpoint
    from efficient_tts_tpu_torch.utils.masks import pad_list

    cfg, params = serving_load.pinned_efts_params()
    model = compat.efts_cnn_from_jax(params, cfg, device="cuda")
    sentences = serving_load.SENTENCES
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = save_checkpoint(os.path.join(tmp, "efts"), {"params": model, "opt_state": None, "step": 0})
        with open(os.path.join(tmp, "efts", "config.yml"), "w") as f:
            json.dump({"model_name": "EfficientTTSCNN", "model_params": dataclasses.asdict(cfg)}, f)
        scp = os.path.join(tmp, "test.txt")
        with open(scp, "w") as f:
            f.writelines(f"wavs/u{i}.wav|{t}\n" for i, t in enumerate(sentences))
        mrf.reset_launches()
        inference.main(["--test_fid_scp", scp, "--checkpoint", ckpt, "--outdir", os.path.join(tmp, "out"),
                        "--batch_size", str(len(sentences)), "--repeats", "2",
                        "--timing_json", os.path.join(tmp, "timing.json")])
        launches = new_launches["inference_cli", "f32"] = dict(mrf.launches)
        with open(os.path.join(tmp, "timing.json")) as f:
            timing = json.load(f)
        seqs = [np.asarray(text_to_sequence(t), np.int32) for t in sentences]
        wav, wl = pipeline.synthesize(model, voc, pad_list(seqs), np.asarray([len(x) for x in seqs], np.int32))
        steps = []
        for i in range(len(sentences)):
            sr, pcm = wavfile.read(os.path.join(tmp, "out", f"u{i}_gen.wav"))
            want = (np.clip(wav[i, : int(wl[i])], -1.0, 1.0) * 32767).astype(np.int16)
            if sr != voc.cfg.sampling_rate or pcm.shape != want.shape:
                raise AssertionError(f"the inference CLI wrote {pcm.shape} at {sr} Hz, expected {want.shape}")
            steps.append(int(np.abs(pcm.astype(np.int32) - want).max()))
    log({"phase": "main_path", "what": "bin.inference", "dtype": "f32", "utterances": len(sentences),
         "passes": timing["passes"], "mrf_launches": keyed(launches), "max_pcm_steps_vs_pipeline": max(steps),
         "pyyaml": yaml_available()})
    # one batch of the three sentences in each of the two passes
    if max(steps) != 0 or launches != stage_launches(stages, "f32", 2):
        raise AssertionError(f"the inference CLI: PCM steps {steps}, launches {launches}")


def yaml_available():
    import importlib.util

    return importlib.util.find_spec("yaml") is not None


def http_get(port, path):
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as r:
        return r.read()


def load_bench_phase(torch, engines, new_launches):
    """4l: the load bench's arms through each warm engine of 4k, then one
    arm under torch.profiler for the device's idle share."""
    from efficient_tts_tpu_torch.bench import serving_load
    from efficient_tts_tpu_torch.ops import mrf

    sustained = SERVE_MAX_BATCH / (engines["f32"][1] / 1e3)
    for dname, (engine, batch_ms) in engines.items():
        rng = np.random.default_rng(0)
        mrf.reset_launches()
        for qps in (*LOAD_QPS, sustained):
            row = serving_load.run_load(engine, qps, LOAD_SECONDS, rng, max_queue=256, deadline_ms=2000.0)
            log({"phase": "load_bench", "dtype": dname, **row, "batch_ms": batch_ms,
                 "p99_over_batch_ms": row["p99_ms"] / batch_ms if row["p99_ms"] is not None else None})
            if row["completed"] == 0:
                raise AssertionError(f"the load bench's {qps} QPS arm in {dname} completed nothing: {row}")
        new_launches["serving_load", dname] = dict(mrf.launches)
        # the idle share: one short arm at 16 QPS under the profiler (its
        # latencies carry the profiler's host cost and are not an arm's)
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            row = serving_load.run_load(engine, 16.0, PROFILED_SECONDS, rng, max_queue=256, deadline_ms=2000.0)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        busy = 0.0
        for evt in prof.key_averages():
            if evt.device_type == DeviceType.CUDA:
                us = getattr(evt, "self_device_time_total", None)
                busy += (us if us is not None else evt.self_cuda_time_total) / 1e6
        log({"phase": "load_bench", "what": "profiled arm", "dtype": dname, "offered_qps": 16.0,
             "seconds": wall, "completed": row["completed"], "device_busy_s": busy if busy else "not measured",
             "idle_share": 1.0 - busy / wall if busy else "not measured"})


def corpus_batch(rng, num_symbols, odim):
    """4m-i's ragged batch of 4 at T1=64, T2=256: seeded ids and N(0, 1) mel
    targets, zero past each length."""
    tl, ml = np.array([64, 50, 37, 20], np.int32), np.array([256, 200, 150, 96], np.int32)
    text = np.zeros((4, 64), np.int32)
    for i, n in enumerate(tl):
        text[i, :n] = rng.integers(1, num_symbols, n)
    mel = rng.standard_normal((4, 256, odim)).astype(np.float32)
    mel *= np.arange(256)[None, :, None] < ml[:, None, None]
    return {"text": text, "text_lengths": tl, "mel": mel, "mel_lengths": ml}


def epoch_split(step_times):
    """Mean step wall and data wait of the first epoch and of the later ones."""
    out = {}
    for name, rows in (("epoch_1", [r for r in step_times if r["epoch"] == 0]),
                       ("later_epochs", [r for r in step_times if r["epoch"] > 0])):
        if rows:
            out[name] = {"steps": len(rows), "wall_ms": 1e3 * float(np.mean([r["wall_s"] for r in rows])),
                         "data_wait_ms": 1e3 * float(np.mean([r["data_wait_s"] for r in rows]))}
    return out


def corpus_training_phase(torch, voc, stages, new_launches, work, device="cuda"):
    """4m: EFTS-CNN at `configs/lj_efts_cnn_char.yaml`'s widths trained on a
    seeded synthetic corpus through the training CLI, then the inference
    CLI on its checkpoint, and the EFTS-Transformer through the same CLI.
    The corpus and the checkpoints are written under `work`. Returns the
    flash launches of the transformer's CLI run and {"corpus", "cnn_checkpoint",
    "work"} for 4n. `device` is the card; "cpu" rehearses the phase's control
    flow at a small config."""
    import contextlib

    from scipy.io import wavfile

    from efficient_tts_tpu_torch import compat, init, native, pipeline
    from efficient_tts_tpu_torch.bench import time_ms
    from efficient_tts_tpu_torch.bench.corpus import make_corpus
    from efficient_tts_tpu_torch.bin import inference, train
    from efficient_tts_tpu_torch.data.collate import collate_text_mel
    from efficient_tts_tpu_torch.data.dataset import TextMelDataset, load_filepaths_and_text
    from efficient_tts_tpu_torch.ops import flash_attention as fa
    from efficient_tts_tpu_torch.ops import mrf
    from efficient_tts_tpu_torch.text import text_to_sequence
    from efficient_tts_tpu_torch.train.efts_train_step import batch_to_device, make_train_step
    from efficient_tts_tpu_torch.train.optim import optimizer_from_dict
    from efficient_tts_tpu_torch.train.state import create_state, named_params
    from efficient_tts_tpu_torch.utils.config import load_config, model_config_from_dict
    from efficient_tts_tpu_torch.utils.masks import pad_list
    from efficient_tts_tpu_torch.utils.precision import full_f32

    configs = os.path.join(os.path.dirname(os.path.abspath(__file__)), "efficient_tts_tpu_torch", "configs")
    char_yaml = os.path.join(configs, "lj_efts_cnn_char.yaml")
    config = load_config(char_yaml)
    cfg = model_config_from_dict(config)

    # i. the card against the CPU: the first step's loss and gradients
    params = init.init_efts(4, cfg)
    batch = corpus_batch(np.random.default_rng(4), cfg.num_symbols, cfg.odim)
    grads, losses = {}, {}
    dev = torch.device(device)
    for dname in (device, "cpu"):
        model = compat.efts_cnn_from_jax(params, cfg, device=dname, trainable=True)
        b = batch_to_device(batch, torch.device(dname))
        with full_f32():
            out = model(b["text"], b["text_lengths"], b["mel"], b["mel_lengths"])
            named = named_params(model)
            g = torch.autograd.grad(out["loss"], list(named.values()))
        grads[dname] = {n: x.detach().cpu() for n, x in zip(named, g)}
        losses[dname] = float(out["loss"].detach())
        del model, out, g, named
    g_max = max(float(x.abs().max()) for x in grads["cpu"].values())
    fails, worst = [], (0.0, "")
    for name, ref in grads["cpu"].items():
        err, own = float((grads[device][name] - ref).abs().max()), float(ref.abs().max())
        if err > CNN_CPU_TOL["leaf_of_own_max"] * own + CNN_CPU_TOL["leaf_of_tree_max"] * g_max:
            fails.append((name, err, own))
        # the worst among leaves above rounding (the text key's bias has a
        # true gradient of 0: the softmax is shift-invariant)
        if own > 1e-3 * g_max:
            worst = max(worst, (err / own, name))
    log({"phase": "train_card_vs_cpu", "model": "efts_cnn", "widths": "lj_efts_cnn_char.yaml", "B": 4,
         "T1": 64, "T2": 256, "loss": losses[device], "loss_cpu": losses["cpu"], "leaves": len(grads["cpu"]),
         "worst_leaf_err_of_own_max": worst[0], "worst_leaf": worst[1], "failing_leaves": fails[:5],
         "tolerance": CNN_CPU_TOL})
    if fails or abs(losses[device] - losses["cpu"]) > CNN_CPU_TOL["loss_rel"] * abs(losses["cpu"]):
        raise AssertionError(f"EFTS-CNN's first step on the card disagrees with the CPU: {fails[:5]}")
    del grads

    with contextlib.nullcontext(work) as tmp:
        # ii. the corpus
        t0 = time.perf_counter()
        corpus = make_corpus(tmp, CORPUS_TRAIN, CORPUS_DEV, seed=0)
        secs = corpus["seconds"]
        log({"phase": "corpus", "train": CORPUS_TRAIN, "dev": CORPUS_DEV, "seconds_min": float(secs.min()),
             "seconds_mean": float(secs.mean()), "seconds_max": float(secs.max()),
             "hours": float(secs.sum() / 3600), "made_s": time.perf_counter() - t0, "mel_backend": native.backend()})
        data_sets = ["--set", f"dataset_params.wav_path={corpus['wavs']}",
                     "--set", f"dataset_params.mel_memory_cache_mb={CORPUS_MEL_CACHE_MB}"]

        # iii. the training CLI: 12 steps (3 batches an epoch), then a resume to 14
        cnn_out = os.path.join(tmp, "exp_cnn")
        cpu = ["--use_cpu"] if dev.type == "cpu" else []
        cnn_args = [*cpu, "--config", char_yaml, "--train_fid_scp", corpus["train"], "--dev_fid_scp", corpus["dev"],
                    "--outdir", cnn_out, *data_sets, "--set", "save_interval_steps=6", "--set",
                    "eval_interval_steps=6", "--set", "log_interval_steps=3"]
        mrf.reset_launches()
        fa.reset_launches()
        t0 = time.perf_counter()
        trainer = train.main(cnn_args + ["--set", "train_max_steps=12"])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        losses = [m["loss"] for m in trainer.metrics_log]
        saved = sorted(n for n in os.listdir(cnn_out) if n.startswith("checkpoint-"))
        log({"phase": "main_path", "what": "bin.train, EFTS-CNN", "steps": trainer.state["step"],
             "batch_size": int(config["batch_size"]), "seconds": cli_s, "losses": losses,
             "evals": list(trainer.eval_log), "checkpoints": saved, "mel_backend": native.backend(),
             "step_times": epoch_split(trainer.step_times),
             "step_wall_ms": [1e3 * r["wall_s"] for r in trainer.step_times],
             "data_wait_ms": [1e3 * r["data_wait_s"] for r in trainer.step_times],
             "launches": {"mrf": keyed(mrf.launches), "flash": keyed(fa.launches)}})
        if (trainer.state["step"] != 12 or len(losses) != 12 or not all(math.isfinite(v) for v in losses)
                or [e["step"] for e in trainer.eval_log] != [6, 12]
                or not all(math.isfinite(v) for e in trainer.eval_log for v in e.values())
                or saved != ["checkpoint-12steps", "checkpoint-6steps"]
                or not os.path.exists(os.path.join(cnn_out, "config.yml")) or mrf.launches or fa.launches):
            raise AssertionError(f"the EFTS-CNN training CLI: step {trainer.state['step']}, losses {losses}, "
                                 f"evals {trainer.eval_log}, checkpoints {saved}")
        split = epoch_split(trainer.step_times)
        del trainer
        resumed = train.main(cnn_args + ["--resume", os.path.join(cnn_out, "checkpoint-12steps"),
                                         "--set", "train_max_steps=14"])
        log({"phase": "main_path", "what": "bin.train --resume, EFTS-CNN", "steps": resumed.state["step"],
             "trained_steps": [r["step"] for r in resumed.step_times],
             "losses": [m["loss"] for m in resumed.metrics_log]})
        if resumed.state["step"] != 14 or [r["step"] for r in resumed.step_times] != [13, 14]:
            raise AssertionError(f"the resume trained steps {[r['step'] for r in resumed.step_times]}")
        del resumed

        # the inference CLI on the trained checkpoint: one batch of 8, f32,
        # with the CLI's random V1 vocoder (the weights of `voc`)
        ckpt = os.path.join(cnn_out, "checkpoint-14steps")
        items = load_filepaths_and_text(corpus["dev"])[:8]
        test_scp = os.path.join(tmp, "test.txt")
        with open(test_scp, "w") as f:
            f.writelines(f"{p}|{t}\n" for p, t in items)
        mrf.reset_launches()
        inference.main([*cpu, "--test_fid_scp", test_scp, "--checkpoint", ckpt, "--outdir", os.path.join(tmp, "wavs"),
                        "--batch_size", "8"])
        launches = new_launches["inference_cli_trained", "f32"] = dict(mrf.launches)
        model, _ = inference.load_acoustic_model(ckpt, dev)
        seqs = [np.asarray(text_to_sequence(t), np.int32) for _, t in items]
        wav, wl = pipeline.synthesize(model, voc, pad_list(seqs), np.asarray([len(s) for s in seqs], np.int32),
                                      device=dev)

        lengths, steps = [], []
        for i, (path, _) in enumerate(items):
            sr, pcm = wavfile.read(os.path.join(tmp, "wavs", os.path.splitext(os.path.basename(path))[0] + "_gen.wav"))
            want = (np.clip(wav[i, : int(wl[i])], -1.0, 1.0) * 32767).astype(np.int16)
            if sr != voc.cfg.sampling_rate or pcm.shape != want.shape:
                raise AssertionError(f"the inference CLI wrote {pcm.shape} at {sr} Hz, expected {want.shape}")
            lengths.append(int(pcm.shape[0]))
            steps.append(int(np.abs(pcm.astype(np.int32) - want).max()))
        log({"phase": "main_path", "what": "bin.inference on the trained EFTS-CNN", "checkpoint": "checkpoint-14steps",
             "utterances": len(items), "wav_samples": lengths, "finite": bool(np.isfinite(wav).all()),
             "max_pcm_steps_vs_pipeline": max(steps), "mrf_launches": keyed(launches)})
        if max(steps) != 0 or not np.isfinite(wav).all() or launches != stage_launches(stages, "f32", 1):
            raise AssertionError(f"inference from the trained checkpoint: PCM steps {steps}, launches {launches}")
        del model, wav

        # iv. the EFTS-Transformer through the same CLI: 4 steps at B=64
        tr_overrides = ["model_params.dropout_rate=0.0", "text_bucket=128", "mel_bucket=128",
                        "dataset_params.use_phnseq=false", "model_params.num_symbols=148"]
        tr_args = [*cpu, "--config", os.path.join(configs, "lj_efts_transformer_phnseq.yaml"), "--train_fid_scp",
                   corpus["train"], "--outdir", os.path.join(tmp, "exp_tr"), *data_sets,
                   *[a for o in tr_overrides for a in ("--set", o)], "--set", "train_max_steps=4",
                   "--set", "save_interval_steps=4", "--set", "log_interval_steps=1"]
        mrf.reset_launches()
        fa.reset_launches()
        tr = train.main(tr_args)
        torch.cuda.synchronize()
        tr_flash = dict(fa.launches)
        per_kernel = {k: sum(n for (kern, *_), n in tr_flash.items() if kern == k) for k in ("fwd", "dkv", "dq")}
        tr_losses = [m["loss"] for m in tr.metrics_log]
        log({"phase": "main_path", "what": "bin.train, EFTS-Transformer", "overrides": tr_overrides,
             "steps": tr.state["step"], "losses": tr_losses,
             "flash_launches": keyed(tr_flash), "flash_launches_per_step": {k: n / 4 for k, n in per_kernel.items()},
             "step_times": epoch_split(tr.step_times)})
        # every attention call of a step on the kernels: 4 text-encoder, 2
        # mel-encoder and 4 decoder calls at the yaml's depth
        calls = tr.cfg.n_text_encoder_layer + tr.cfg.n_mel_encoder_layer + tr.cfg.n_decoder_layer
        if (tr.state["step"] != 4 or not all(math.isfinite(v) for v in tr_losses)
                or per_kernel != {k: 4 * calls for k in per_kernel} or mrf.launches
                or any(not seg for (*_, seg) in tr_flash)):
            raise AssertionError(f"the EFTS-Transformer CLI: losses {tr_losses}, flash launches {tr_flash}")
        del tr

        # v. the EFTS-CNN step at B=128 on one collated batch of the corpus:
        # the middle of its three length-sorted batches (the yaml's buckets)
        ds = TextMelDataset(corpus["train"], wav_path=corpus["wavs"])
        bs = int(config["batch_size"])
        middle = np.argsort([ds.approx_length(i) for i in range(len(ds))], kind="stable")[bs:2 * bs]
        t0 = time.perf_counter()
        items = [ds[int(i)] for i in middle]
        extract_ms = 1e3 * (time.perf_counter() - t0) / len(items)
        fixed = batch_to_device(collate_text_mel(items, int(config["text_bucket"]), int(config["mel_bucket"])), dev)
        del items
    model = compat.efts_cnn_from_jax(init.init_efts(0, cfg), cfg, device=dev, trainable=True)
    tx = optimizer_from_dict(config)
    state = create_state(model, tx)
    step = make_train_step(cfg, tx, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_step = time_ms(lambda: step(state, fixed), iters=10)
    peak = torch.cuda.max_memory_allocated()
    prof = device_profile(torch, lambda: step(state, fixed))
    summary = profile_summary(prof, t_step["median"], ()) if prof else {"device_busy_ms": "not measured"}
    t1, t2 = int(fixed["text"].shape[1]), int(fixed["mel"].shape[1])
    log({"phase": "timing", "what": "train_step", "model": "efts_cnn", "B": int(fixed["text"].shape[0]),
         "T1": t1, "T2": t2, "dtype": "f32", "ms": t_step["median"], "ms_p25": t_step["p25"],
         "ms_p75": t_step["p75"], "n": t_step["n"], "max_memory_allocated_gb": peak / 2**30,
         "params_m": sum(p.numel() for p in named_params(model).values()) / 1e6,
         "mel_extraction_ms_per_utterance": extract_ms, "mel_backend": native.backend(), "cli": split,
         **summary})
    del state, step, model, fixed
    return tr_flash, {"corpus": corpus, "cnn_checkpoint": ckpt, "work": work}

def tree_leaves(tree, path=()):
    """(path, array) of every leaf of a nested dict / list tree, in order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from tree_leaves(v, path + (i,))
    else:
        yield path, np.asarray(tree)


def gan_step_card_vs_cpu(torch, voc_cfg, wav_files, device="cuda"):
    """4n-i: the first GAN step on the card against the same step on the CPU,
    f32, B=2 crops of `wav_files`: every metric, every gradient leaf (from
    the first Adam moment, mu = (1 - b1) g) and the spectral norm's u and v."""
    from efficient_tts_tpu_torch import compat, init
    from efficient_tts_tpu_torch.data.collate import collate_mel_audio
    from efficient_tts_tpu_torch.data.dataset import MelAudioSegmentDataset
    from efficient_tts_tpu_torch.train.hifigan_train_step import make_gan_train_step
    from efficient_tts_tpu_torch.train.optim import HiFiGANAdam

    tree = init.init_gan_state(11, voc_cfg)
    ds = MelAudioSegmentDataset(wav_files, segment_size=voc_cfg.segment_size, seed=11)
    batch = collate_mel_audio([ds[i] for i in range(2)])
    tx = HiFiGANAdam()
    runs = {}
    for dname in (device, "cpu"):
        st = compat.gan_state_from_jax(tree, voc_cfg, tx, tx, device=dname)
        t0 = time.perf_counter()
        st, m = make_gan_train_step(voc_cfg, tx, tx, device=dname)(st, batch)
        metrics = {k: float(v) for k, v in m.items()}
        mu = {side: st[side]["opt_state"]["mu"] for side in ("gen", "disc")}
        runs[dname] = (metrics, compat.gan_state_to_jax(st, grads=mu), compat.gan_state_to_jax(st),
                       time.perf_counter() - t0)
        del st, m, mu
    (m_dev, g_dev, p_dev, s_dev), (m_cpu, g_cpu, p_cpu, s_cpu) = runs[device], runs["cpu"]
    metric_err = {k: abs(m_dev[k] - m_cpu[k]) / max(abs(m_cpu[k]), 1e-30) for k in m_cpu}
    fails, worst, whole = [], {}, {}
    for side in ("gen", "disc"):
        worst[side] = {"rel_l2": (0.0, ""), "of_own_max": (0.0, "")}
        num = den = 0.0
        for (path, a), (_, b) in zip(tree_leaves(g_cpu[side]["params"]), tree_leaves(g_dev[side]["params"])):
            name = "/".join(map(str, path))
            d2, a2 = float(((b - a).astype(np.float64) ** 2).sum()), float((a.astype(np.float64) ** 2).sum())
            num, den = num + d2, den + a2
            rel = (d2 / a2) ** 0.5 if a2 else (0.0 if d2 == 0 else math.inf)
            if rel > GAN_CARD_TOL["leaf_rel_l2"]:
                fails.append((side, name, rel))
            own = float(np.abs(a).max())
            worst[side]["rel_l2"] = max(worst[side]["rel_l2"], (rel, name))
            if own:
                worst[side]["of_own_max"] = max(worst[side]["of_own_max"], (float(np.abs(b - a).max()) / own, name))
        whole[side] = (num / den) ** 0.5
        if whole[side] > GAN_CARD_TOL["grad_rel_l2"]:
            fails.append((side, "whole gradient", whole[side]))
    uv_err = max(float(np.abs(b - a).max())
                 for (path, a), (_, b) in zip(tree_leaves(p_cpu["disc"]["params"]["msd"]),
                                              tree_leaves(p_dev["disc"]["params"]["msd"]))
                 if path[-1] in ("u", "v"))
    log({"phase": "train_card_vs_cpu", "model": "hifigan_v1_gan_step", "B": 2, "segment": voc_cfg.segment_size,
         "dtype": "f32", "metrics": m_dev, "metric_rel_err": metric_err, "grad_rel_l2": whole,
         "worst_leaf": worst, "uv_max_abs_err": uv_err, "failing": fails[:5], "card_s": s_dev, "cpu_s": s_cpu,
         "tolerance": GAN_CARD_TOL})
    if (fails or max(metric_err.values()) > GAN_CARD_TOL["metric_rel"] or uv_err > GAN_CARD_TOL["uv_abs"]
            or not all(math.isfinite(v) for v in m_dev.values())):
        raise AssertionError(f"the first GAN step on the card disagrees with the CPU: {metric_err}, {fails[:5]}, "
                             f"u/v {uv_err}")
    del runs, g_dev, g_cpu, p_dev, p_cpu


def vocoder_training_phase(torch, stages, new_launches, trained, device="cuda"):
    """4n: HiFi-GAN V1 training on 4m's corpus: the first GAN step on the card
    against the CPU; `bin.train_vocoder` (f32 with an EMA and evals, a
    resume, bf16); `bin.extract_gta` on 4m's EFTS-CNN checkpoint and GTA
    fine-tuning; `bin.inference` and a bf16 serving engine on the trained
    vocoder; the GAN step's time, profile and memory. `device` is the card;
    "cpu" rehearses the phase's control flow at a small config."""
    from scipy.io import wavfile

    from efficient_tts_tpu_torch import pipeline
    from efficient_tts_tpu_torch.bench import time_ms
    from efficient_tts_tpu_torch.bin import extract_gta, inference, train_vocoder
    from efficient_tts_tpu_torch.bin import serve as serve_cli
    from efficient_tts_tpu_torch.data.collate import collate_mel_audio
    from efficient_tts_tpu_torch.data.dataset import MelAudioSegmentDataset, load_filepaths_and_text
    from efficient_tts_tpu_torch.dsp.mel import num_frames
    from efficient_tts_tpu_torch.ops import mrf
    from efficient_tts_tpu_torch.text import text_to_sequence
    from efficient_tts_tpu_torch.train.hifigan_train_step import (batch_to_device, init_gan_state,
                                                                  make_gan_eval_step, make_gan_train_step)
    from efficient_tts_tpu_torch.train.optim import HiFiGANAdam
    from efficient_tts_tpu_torch.utils.config import load_config, vocoder_config_from_dict
    from efficient_tts_tpu_torch.utils.masks import pad_list

    dev = torch.device(device)
    corpus, work, cnn_ckpt = trained["corpus"], trained["work"], trained["cnn_checkpoint"]
    config_path = os.path.join(work, "vocoder.json")
    if not os.path.exists(config_path):  # HiFi-GAN V1: the defaults
        with open(config_path, "w") as f:
            json.dump({}, f)
    voc_cfg = vocoder_config_from_dict(load_config(config_path))
    cpu = ["--use_cpu"] if dev.type == "cpu" else []
    wavs, scps = {}, {}
    for name in ("train", "dev"):
        wavs[name] = [os.path.join(corpus["wavs"], os.path.basename(p)) for p, _ in load_filepaths_and_text(corpus[name])]
        scps[name] = os.path.join(work, f"{name}_wavs.scp")
        with open(scps[name], "w") as f:
            f.writelines(w + "\n" for w in wavs[name])

    # i. the card against the CPU: the first GAN step
    gan_step_card_vs_cpu(torch, voc_cfg, wavs["train"], device)

    # ii. the vocoder CLI: f32 with an EMA and evals on the dev set, a resume, bf16
    voc_out = os.path.join(work, "exp_vocoder")
    # the host data path (4o runs the device corpus)
    base = [*cpu, "--config", config_path, "--wav_scp", scps["train"], "--batch_size", str(GAN_B),
            "--log_interval_steps", "1", "--max_keep_checkpoints", "2", "--device_corpus", "off"]
    ema = ["--ema_decay", "0.999"]
    mrf.reset_launches()
    t0 = time.perf_counter()
    voc_tr = train_vocoder.main([*base, *ema, "--outdir", voc_out, "--dev_wav_scp", scps["dev"],
                                 "--train_max_steps", "10", "--save_interval_steps", "10", "--eval_interval_steps",
                                 "5"])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    eval_launches = new_launches["train_vocoder_eval", "f32"] = dict(mrf.launches)
    saved = sorted(n for n in os.listdir(voc_out) if n.startswith("checkpoint-"))
    metrics_log = list(voc_tr.metrics_log)
    cli_split = epoch_split(voc_tr.step_times)
    log({"phase": "main_path", "what": "bin.train_vocoder, HiFi-GAN V1", "dtype": "f32", "steps": voc_tr.state["step"],
         "batch_size": GAN_B, "seconds": cli_s, "g_loss": [m["g_loss"] for m in metrics_log],
         "d_loss": [m["d_loss"] for m in metrics_log], "mel_l1": [m["mel_l1"] for m in metrics_log],
         "evals": list(voc_tr.eval_log), "checkpoints": saved, "mrf_launches": keyed(eval_launches),
         "step_times": cli_split, "step_wall_ms": [1e3 * r["wall_s"] for r in voc_tr.step_times],
         "data_wait_ms": [1e3 * r["data_wait_s"] for r in voc_tr.step_times]})
    # each eval vocodes the one batch of 16 dev segments: 18 f32 MRF launches a stage
    if (voc_tr.state["step"] != 10 or len(metrics_log) != 10
            or not all(math.isfinite(v) for m in metrics_log for v in m.values())
            or [e["step"] for e in voc_tr.eval_log] != [5, 10]
            or not all(math.isfinite(e["mel_l1"]) for e in voc_tr.eval_log)
            or saved != ["checkpoint-10steps"] or "ema" not in voc_tr.state
            or eval_launches != stage_launches(stages, "f32", 2)):
        raise AssertionError(f"the vocoder CLI: step {voc_tr.state['step']}, metrics {metrics_log[-1:]}, evals "
                             f"{voc_tr.eval_log}, checkpoints {saved}, launches {eval_launches}")
    eval_batch = voc_tr.eval_batches[0]
    host_cli = {"f32": [{k: r[k] for k in ("step", "wall_s", "data_wait_s")} for r in voc_tr.step_times]}
    del voc_tr
    resumed = train_vocoder.main([*base, *ema, "--outdir", voc_out, "--resume",
                                  os.path.join(voc_out, "checkpoint-10steps"), "--train_max_steps", "12",
                                  "--save_interval_steps", "12"])
    log({"phase": "main_path", "what": "bin.train_vocoder --resume", "steps": resumed.state["step"],
         "trained_steps": [r["step"] for r in resumed.step_times],
         "g_loss": [m["g_loss"] for m in resumed.metrics_log]})
    if resumed.state["step"] != 12 or [r["step"] for r in resumed.step_times] != [11, 12]:
        raise AssertionError(f"the vocoder resume trained steps {[r['step'] for r in resumed.step_times]}")
    voc_ckpt = os.path.join(voc_out, "checkpoint-12steps")
    folded = resumed.state["ema"].fold()
    del resumed
    bf = train_vocoder.main([*base, "--outdir", os.path.join(work, "exp_vocoder_bf16"), "--compute_dtype",
                             "bfloat16", "--train_max_steps", "3", "--save_interval_steps", "3"])
    bf_log = list(bf.metrics_log)
    host_cli["bf16"] = [{k: r[k] for k in ("step", "wall_s", "data_wait_s")} for r in bf.step_times]
    log({"phase": "main_path", "what": "bin.train_vocoder --compute_dtype bfloat16", "steps": bf.state["step"],
         "g_loss": [m["g_loss"] for m in bf_log], "d_loss": [m["d_loss"] for m in bf_log],
         "step_wall_ms": [1e3 * r["wall_s"] for r in bf.step_times]})
    if bf.state["step"] != 3 or not all(math.isfinite(v) for m in bf_log for v in m.values()):
        raise AssertionError(f"the bf16 vocoder CLI: {bf_log}")
    del bf
    # the interval saves, without pruning (which waits for each write)
    interval_saves_phase(torch, train_vocoder, [*cpu, "--config", config_path, "--wav_scp", scps["train"],
                                                "--batch_size", str(GAN_B), "--log_interval_steps", "1",
                                                "--device_corpus", "off"], os.path.join(work, "exp_vocoder_saves"))

    # iii. GTA mels from 4m's EFTS-CNN checkpoint, then fine-tuning on them
    gta = os.path.join(work, "gta")
    t0 = time.perf_counter()
    n_gta = extract_gta.main([*cpu, "--fid_scp", corpus["train"], "--checkpoint", cnn_ckpt, "--outdir", gta,
                              "--batch_size", "32"])
    gta_s = time.perf_counter() - t0
    shapes_ok = all(np.load(os.path.join(gta, os.path.splitext(os.path.basename(w))[0] + ".npy")).shape
                    == (voc_cfg.num_mels, num_frames(wavfile.read(w)[1].shape[0])) for w in wavs["train"][:32])
    ft = train_vocoder.main([*base, "--outdir", os.path.join(work, "exp_vocoder_ft"), "--fine_tuning",
                             "--base_mels_path", gta, "--train_max_steps", "2", "--save_interval_steps", "2"])
    ft_log = list(ft.metrics_log)
    log({"phase": "main_path", "what": "bin.extract_gta + bin.train_vocoder --fine_tuning", "gta_mels": n_gta,
         "gta_seconds": gta_s, "lengths_match_wavs": shapes_ok, "steps": ft.state["step"],
         "g_loss": [m["g_loss"] for m in ft_log]})
    if (n_gta != len(wavs["train"]) or not shapes_ok or ft.state["step"] != 2
            or not all(math.isfinite(v) for m in ft_log for v in m.values())):
        raise AssertionError(f"GTA extraction and fine-tuning: {n_gta} mels, lengths {shapes_ok}, {ft_log}")
    del ft

    # iv. the inference CLI on 4m's EFTS-CNN and the trained vocoder (its EMA),
    # f32 through the f32 MRF kernel, PCM against pipeline.synthesize
    items = load_filepaths_and_text(corpus["dev"])[:8]
    test_scp = os.path.join(work, "test_vocoder.txt")
    with open(test_scp, "w") as f:
        f.writelines(f"{p}|{t}\n" for p, t in items)
    loaded = inference.load_vocoder(voc_ckpt, dev)
    same_fold = all(torch.equal(loaded.state_dict()[k], v) for k, v in folded.state_dict().items())
    mrf.reset_launches()
    inference.main([*cpu, "--test_fid_scp", test_scp, "--checkpoint", cnn_ckpt, "--outdir",
                    os.path.join(work, "wavs_vocoder"), "--batch_size", "8", "--vocoder_checkpoint", voc_ckpt])
    inf_launches = new_launches["inference_cli_trained_vocoder", "f32"] = dict(mrf.launches)
    model, _ = inference.load_acoustic_model(cnn_ckpt, dev)
    seqs = [np.asarray(text_to_sequence(t), np.int32) for _, t in items]
    wav, wl = pipeline.synthesize(model, folded, pad_list(seqs), np.asarray([len(x) for x in seqs], np.int32),
                                  device=dev)
    steps = []
    for i, (path, _) in enumerate(items):
        sr, pcm = wavfile.read(os.path.join(work, "wavs_vocoder", os.path.splitext(os.path.basename(path))[0]
                                            + "_gen.wav"))
        want = (np.clip(wav[i, : int(wl[i])], -1.0, 1.0) * 32767).astype(np.int16)
        if sr != voc_cfg.sampling_rate or pcm.shape != want.shape:
            raise AssertionError(f"the inference CLI wrote {pcm.shape} at {sr} Hz, expected {want.shape}")
        steps.append(int(np.abs(pcm.astype(np.int32) - want).max()))
    # the eval step's vocoding through the f32 kernel against its plain version
    eval_k = make_gan_eval_step(voc_cfg, device=dev)(folded, eval_batch)
    eval_p = make_gan_eval_step(voc_cfg, mrf_impl="plain", device=dev)(folded, eval_batch)
    eval_stats = err_stats(eval_k["wav"], eval_p["wav"])
    eval_ok = eval_stats["max_abs_err"] <= F32_WAV_TOL["max_abs"] and eval_stats["rel_rms"] <= F32_WAV_TOL["rel_rms"]
    log({"phase": "main_path", "what": "bin.inference on the trained vocoder", "checkpoint": "checkpoint-12steps (EMA)",
         "utterances": len(items), "max_pcm_steps_vs_pipeline": max(steps), "load_vocoder_equals_fold": same_fold,
         "mrf_launches": keyed(inf_launches), "eval_mel_l1_kernel": float(eval_k["mel_l1"]),
         "eval_mel_l1_plain": float(eval_p["mel_l1"]), "eval_wav_vs_plain": eval_stats, "tolerance": F32_WAV_TOL})
    if (max(steps) != 0 or not same_fold or inf_launches != stage_launches(stages, "f32", 1) or not eval_ok
            or not np.isfinite(wav).all()):
        raise AssertionError(f"inference on the trained vocoder: PCM steps {steps}, fold {same_fold}, launches "
                             f"{inf_launches}, eval vs plain {eval_stats}")
    del model, wav, eval_k, eval_p

    # the serving CLI's engine on the same checkpoints in bf16: K1's stages
    args = serve_cli.get_parser().parse_args(["--checkpoint", cnn_ckpt, "--vocoder_checkpoint", voc_ckpt, "--bf16",
                                              "--no_warmup", *(["--use_cpu"] if cpu else [])])
    engine = serve_cli.build_engine(args)
    mrf.reset_launches()
    served = engine.synthesize([t for _, t in items])
    serve_launches = new_launches["serve_trained_vocoder", "bf16"] = dict(mrf.launches)
    log({"phase": "main_path", "what": "bin.serve engine on the trained vocoder", "dtype": "bf16",
         "texts": len(items), "samples": [len(w) for w in served], "mrf_launches": keyed(serve_launches)})
    if (sorted(serve_launches) != sorted(stage_launches(stages, "bf16", 1))
            or any(n % 18 for n in serve_launches.values()) or not all(np.isfinite(w).all() for w in served)):
        raise AssertionError(f"the bf16 engine on the trained vocoder: launches {serve_launches}")
    del engine, served

    # v. the GAN step at B=16, segment 8192: CUDA events, profile, peak memory
    ds = MelAudioSegmentDataset(wavs["train"], segment_size=voc_cfg.segment_size, seed=5)
    fixed = batch_to_device(collate_mel_audio([ds[i] for i in range(GAN_B)]), dev)
    tx = HiFiGANAdam()
    for cdt, dname in ((None, "f32"), (torch.bfloat16, "bf16")):
        state = init_gan_state(0, voc_cfg, tx, tx, ema_decay=0.999, device=dev)
        step = make_gan_train_step(voc_cfg, tx, tx, ema_decay=0.999, compute_dtype=cdt, device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t_step = time_ms(lambda: step(state, fixed), iters=10)
        peak = torch.cuda.max_memory_allocated()
        prof = device_profile(torch, lambda: step(state, fixed))
        summary = profile_summary(prof, t_step["median"], ()) if prof else {"device_busy_ms": "not measured"}
        log({"phase": "timing", "what": "gan_train_step", "model": "hifigan_v1 + mpd + msd", "B": GAN_B,
             "segment": voc_cfg.segment_size, "dtype": dname, "ms": t_step["median"], "ms_p25": t_step["p25"],
             "ms_p75": t_step["p75"], "n": t_step["n"], "max_memory_allocated_gb": peak / 2**30,
             "params_m": {side: sum(p.numel() for p in state[side]["params"].parameters()) / 1e6
                          for side in ("gen", "disc")},
             "cli_f32": cli_split, **summary})
        del state, step
    return {"voc_cfg": voc_cfg, "config": config_path, "wavs": wavs, "scps": scps, "host_cli": host_cli,
            "work": work, "checkpoint": voc_ckpt, "test_scp": test_scp,
            "wavs_vocoder": os.path.join(work, "wavs_vocoder")}


def interval_saves_phase(torch, train_vocoder, base, outdir):
    """4n-ii: the vocoder CLI's interval saves of the V1 GAN state, 6 steps
    saving every 2: the save at step 2 made to wait for its write (as every
    save did before they went to the background), those at 4 and 6 not. For
    each save the time it held the training thread; the step wall at a save
    step is the step's own wall plus that time, and the next step's wall
    shows the background write's cost to training."""
    from efficient_tts_tpu_torch.train import checkpoint as ckpt
    from efficient_tts_tpu_torch.train import hifigan_trainer

    real = hifigan_trainer.HiFiGANTrainer.save
    saves = []

    def timed(self, wait=False, name=None):
        wait = wait or (name is None and self.state["step"] == 2)
        t0 = time.perf_counter()
        path = real(self, wait=wait, name=name)
        saves.append({"step": self.state["step"], "wait": wait, "held_ms": 1e3 * (time.perf_counter() - t0)})
        return path

    hifigan_trainer.HiFiGANTrainer.save = timed
    try:
        t0 = time.perf_counter()
        tr = train_vocoder.main([*base, "--outdir", outdir, "--train_max_steps", "6", "--save_interval_steps", "2"])
        seconds = time.perf_counter() - t0
    finally:
        hifigan_trainer.HiFiGANTrainer.save = real
    walls = {r["step"]: 1e3 * r["wall_s"] for r in tr.step_times}
    rows = [{**sv, "save_step_wall_ms": walls[sv["step"]] + sv["held_ms"],
             "next_step_wall_ms": walls.get(sv["step"] + 1)} for sv in saves]
    nbytes = os.path.getsize(os.path.join(outdir, "checkpoint-6steps"))
    log({"phase": "timing", "what": "bin.train_vocoder interval saves, HiFi-GAN V1", "batch_size": GAN_B,
         "checkpoint_bytes": nbytes, "saves": rows, "step_wall_ms": walls, "seconds": seconds})
    if ([(r["step"], r["wait"]) for r in rows] != [(2, True), (4, False), (6, False)]
            or sorted(os.listdir(outdir)) != ["checkpoint-2steps", "checkpoint-4steps", "checkpoint-6steps",
                                              "config.yml"]):
        raise AssertionError(f"the vocoder CLI's interval saves: {rows}, files {sorted(os.listdir(outdir))}")
    saved = ckpt.read_checkpoint(os.path.join(outdir, "checkpoint-6steps"))
    for k, v in tr.state["gen"]["params"].state_dict().items():
        if not torch.equal(saved["gen"]["params"][k], v.cpu()):
            raise AssertionError(f"the background save of step 6 differs from the state at its end: {k}")
    shutil.rmtree(outdir)


def step_walls(step_times):
    """(wall ms, data wait ms) of each logged step of a CLI run."""
    return [1e3 * r["wall_s"] for r in step_times], [1e3 * r["data_wait_s"] for r in step_times]


def first_update_vs_cpu(torch, runs, moment, beta1):
    """4o-iii/iv: the card's first update against the CPU's. `runs` maps the
    device to (parameters before, after, optimizer state), each {name:
    tensor}; the gradients are read from the first moment, `moment` (beta1 g
    after one step). Returns the gradients' worst leaf by relative L2 and
    the updates' worst relative error where the CPU's gradient is at least
    UPDATE_TOL["above_of_leaf_max"] of its leaf's largest, in the leaves
    whose gradient is at least UPDATE_TOL["leaf_above_of_global"] of the
    whole's norm."""
    (dev_b, dev_a, dev_s), (cpu_b, cpu_a, cpu_s) = runs["card"], runs["cpu"]
    g_dev, g_cpu = (moment(s) for s in (dev_s, cpu_s))
    g_norm = math.sqrt(sum(float(g.double().square().sum()) for g in g_cpu.values())) / (1 - beta1)
    grad_worst, upd_worst, fails = (0.0, ""), (0.0, ""), []
    for n, gc in g_cpu.items():
        gd = g_dev[n].cpu() / (1 - beta1)
        gc = gc / (1 - beta1)
        err, ref = float((gd - gc).double().norm()), float(gc.double().norm())
        if err > UPDATE_TOL["grad_leaf_rel_l2"] * ref + UPDATE_TOL["grad_abs_of_global"] * g_norm:
            fails.append((n, "gradient", err, ref))
        if ref <= UPDATE_TOL["leaf_above_of_global"] * g_norm:
            continue  # a gradient at rounding level (an attention key's bias: the softmax is shift-invariant)
        grad_worst = max(grad_worst, (err / ref, n))
        keep = gc.abs() >= UPDATE_TOL["above_of_leaf_max"] * float(gc.abs().max())
        ud, uc = (dev_a[n].cpu() - dev_b[n].cpu())[keep], (cpu_a[n] - cpu_b[n])[keep]
        if keep.any():
            rel = float(((ud - uc).abs() / uc.abs().clamp(min=1e-30)).max())
            upd_worst = max(upd_worst, (rel, n))
            if rel > UPDATE_TOL["update_rel"]:
                fails.append((n, "update", rel))
    return grad_worst, upd_worst, fails


def device_corpus_phase(torch, stages, new_launches, voc, trained, device="cuda"):
    """4o: the vocoder corpus held on the card (`data/device_corpus.py`) at
    HiFi-GAN V1, B=16, segment 8192, on 4m's corpus and 4n's files; a
    registry optimizer through `bin.train`; the DurationModel at the JAX
    package's default widths. Returns the flash launches of the registry
    run. `voc` is what 4n returns, `trained` what 4m returns. `device` is
    the card; "cpu" rehearses the phase's control flow at a small config."""
    from efficient_tts_tpu_torch.bench import time_ms
    from efficient_tts_tpu_torch.bin import train_vocoder
    from efficient_tts_tpu_torch.data import device_corpus as dc
    from efficient_tts_tpu_torch.ops import mrf
    from efficient_tts_tpu_torch.train.hifigan_train_step import init_gan_state, make_gan_train_step
    from efficient_tts_tpu_torch.train.optim import HiFiGANAdam

    dev = torch.device(device)
    voc_cfg, seg, wavs, scps, work = voc["voc_cfg"], voc["voc_cfg"].segment_size, voc["wavs"], voc["scps"], voc["work"]

    # i. the corpus on the card, its crops and mels against the CPU's
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    corpus = dc.load_corpus(wavs["train"], segment_size=seg, device=dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    nbytes, estimate = corpus["wav"].nbytes, dc.corpus_nbytes(wavs["train"], seg)
    pinned = corpus["wav"].cpu()
    pinned = pinned.pin_memory() if dev.type == "cuda" else pinned
    upload = time_ms(lambda: pinned.to(dev, non_blocking=True), iters=3, warmup=1)
    del pinned
    batcher = dc.make_device_batch_fn(GAN_B, segment_size=seg, device=dev)
    lens = corpus["len"].long()
    crops_ok = True
    for s in range(8):
        idx, start = batcher.crop_positions(corpus["len"], s)
        again = batcher.crop_positions(corpus["len"], s)
        crops_ok &= bool(torch.equal(idx, again[0]) and torch.equal(start, again[1])
                         and ((start >= 0) & (start <= torch.clamp(lens[idx] - seg, min=0))).all())
    idx, start = batcher.crop_positions(corpus["len"], 3)
    got = batcher(corpus, 3)
    ref = dc.make_device_batch_fn(GAN_B, segment_size=seg, device="cpu").batch_from_positions(
        {k: v.cpu() for k, v in corpus.items()}, idx.cpu(), start.cpu())
    audio_equal = bool(torch.equal(got["audio"].cpu(), ref["audio"]))
    mel_err = {k: float((got[k].cpu() - ref[k]).abs().max() / ref[k].abs().max()) for k in ("mel", "mel_loss")}
    t_batch = time_ms(lambda: batcher(corpus, 5))
    log({"phase": "main_path", "what": "data.device_corpus", "wavs": len(wavs["train"]),
         "shape": list(corpus["wav"].shape), "bytes": nbytes, "corpus_nbytes": estimate, "load_s": load_s,
         "upload_ms": upload["median"], "upload_gb_s": nbytes / upload["median"] / 1e6,
         "crops_deterministic_in_bounds": crops_ok, "audio_equal_cpu": audio_equal,
         "mel_err_of_max_vs_cpu": mel_err, "tolerance": DEVICE_BATCH_MEL_TOL, "batch_ms": t_batch["median"],
         "batch_ms_p25": t_batch["p25"], "batch_ms_p75": t_batch["p75"], "B": GAN_B, "segment": seg})
    if (nbytes != estimate or not crops_ok or not audio_equal or max(mel_err.values()) > DEVICE_BATCH_MEL_TOL
            or got["mel"].shape != (GAN_B, seg // voc_cfg.hop_size, voc_cfg.num_mels)):
        raise AssertionError(f"the device corpus: bytes {nbytes} vs {estimate}, crops {crops_ok}, audio "
                             f"{audio_equal}, mel {mel_err}")
    del got, ref

    # ii. bin.train_vocoder on the device path: f32 with an EMA and an eval, a
    # resume, bf16 under auto; the crops each step drew are recorded
    recorded = []
    draw = dc.DeviceBatcher.crop_positions

    def recording(self, corpus_len, step):
        out = draw(self, corpus_len, step)
        recorded.append((int(step), out))
        return out

    out_dir = os.path.join(work, "exp_vocoder_device")
    base = ["--config", voc["config"], "--wav_scp", scps["train"], "--batch_size", str(GAN_B),
            "--log_interval_steps", "1", "--max_keep_checkpoints", "2", *(["--use_cpu"] if dev.type == "cpu" else [])]
    with contextlib.ExitStack() as undo:
        dc.DeviceBatcher.crop_positions = recording
        undo.callback(setattr, dc.DeviceBatcher, "crop_positions", draw)
        mrf.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tr = train_vocoder.main([*base, "--ema_decay", "0.999", "--outdir", out_dir, "--dev_wav_scp", scps["dev"],
                                 "--train_max_steps", "6", "--save_interval_steps", "4", "--eval_interval_steps",
                                 "6", "--device_corpus", "on"])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        eval_launches = new_launches["train_vocoder_device_corpus_eval", "f32"] = dict(mrf.launches)
        whole = [(s, i.cpu(), st.cpu()) for s, (i, st) in recorded]
        f32_log, saved = list(tr.metrics_log), sorted(n for n in os.listdir(out_dir) if n.startswith("checkpoint-"))
        f32_wall, f32_wait = step_walls(tr.step_times)
        path, evals, ema = tr.data_path, list(tr.eval_log), "ema" in tr.state
        del tr
        recorded.clear()
        resumed = train_vocoder.main([*base, "--ema_decay", "0.999", "--outdir", out_dir, "--resume",
                                      os.path.join(out_dir, "checkpoint-4steps"), "--train_max_steps", "6",
                                      "--save_interval_steps", "100", "--device_corpus", "on"])
        again = [(s, i.cpu(), st.cpu()) for s, (i, st) in recorded]
        resumed_steps = [r["step"] for r in resumed.step_times]
        del resumed
    same_crops = [s for s, _, _ in again] == [4, 5] and all(
        torch.equal(a[1], b[1]) and torch.equal(a[2], b[2]) for a, b in zip(again, whole[4:6]))
    log({"phase": "main_path", "what": "bin.train_vocoder --device_corpus on, HiFi-GAN V1", "dtype": "f32",
         "data_path": path, "steps": len(f32_log), "batch_size": GAN_B, "seconds": cli_s,
         "g_loss": [m["g_loss"] for m in f32_log], "mel_l1": [m["mel_l1"] for m in f32_log], "evals": evals,
         "checkpoints": saved, "mrf_launches": keyed(eval_launches), "max_memory_allocated_gb": peak / 2**30,
         "step_wall_ms": f32_wall, "data_wait_ms": f32_wait,
         "host_path_step_wall_ms": [1e3 * r["wall_s"] for r in voc["host_cli"]["f32"]],
         "host_path_data_wait_ms": [1e3 * r["data_wait_s"] for r in voc["host_cli"]["f32"]],
         "resumed_steps": resumed_steps, "resume_crops_equal_uninterrupted": same_crops})
    if (path != "device" or len(f32_log) != 6 or not all(math.isfinite(v) for m in f32_log for v in m.values())
            or [e["step"] for e in evals] != [6] or not ema or saved != ["checkpoint-4steps", "checkpoint-6steps"]
            or eval_launches != stage_launches(stages, "f32", 1) or resumed_steps != [5, 6] or not same_crops
            or [s for s, _, _ in whole] != list(range(6))):
        raise AssertionError(f"the vocoder CLI on the device corpus: path {path}, metrics {f32_log[-1:]}, evals "
                             f"{evals}, checkpoints {saved}, launches {eval_launches}, resume {resumed_steps}, "
                             f"crops {same_crops}")
    try:
        train_vocoder.main([*base, "--outdir", os.path.join(work, "exp_vocoder_ft_on"), "--device_corpus", "on",
                            "--fine_tuning", "--base_mels_path", os.path.join(work, "gta")])
        raise AssertionError("--device_corpus on with --fine_tuning did not raise")
    except ValueError as e:
        if "GTA mels" not in str(e):
            raise
    bf = train_vocoder.main([*base, "--outdir", os.path.join(work, "exp_vocoder_device_bf16"), "--compute_dtype",
                             "bfloat16", "--train_max_steps", "6", "--save_interval_steps", "6"])
    bf_log = list(bf.metrics_log)
    bf_wall, bf_wait = step_walls(bf.step_times)
    log({"phase": "main_path", "what": "bin.train_vocoder --device_corpus auto --compute_dtype bfloat16",
         "data_path": bf.data_path, "steps": len(bf_log), "g_loss": [m["g_loss"] for m in bf_log],
         "step_wall_ms": bf_wall, "data_wait_ms": bf_wait,
         "host_path_step_wall_ms": [1e3 * r["wall_s"] for r in voc["host_cli"]["bf16"]],
         "host_path_data_wait_ms": [1e3 * r["data_wait_s"] for r in voc["host_cli"]["bf16"]],
         "on_with_fine_tuning": "raised"})
    if bf.data_path != "device" or len(bf_log) != 6 or not all(math.isfinite(v) for m in bf_log for v in m.values()):
        raise AssertionError(f"the bf16 vocoder CLI under auto: path {bf.data_path}, {bf_log}")
    del bf

    # the device-path step (batch built on the card, then the GAN step), timed
    # as 4n-v times the host path's step on a batch already on the card
    tx = HiFiGANAdam()
    for cdt, dname in ((None, "f32"), (torch.bfloat16, "bf16")):
        state = init_gan_state(0, voc_cfg, tx, tx, ema_decay=0.999, device=dev)
        step = dc.make_device_gan_train_step(
            make_gan_train_step(voc_cfg, tx, tx, ema_decay=0.999, compute_dtype=cdt, device=dev), batcher)
        t_step = time_ms(lambda: step(state, corpus), iters=10)
        prof = device_profile(torch, lambda: step(state, corpus))
        summary = profile_summary(prof, t_step["median"], ()) if prof else {"device_busy_ms": "not measured"}
        log({"phase": "timing", "what": "device_corpus gan_train_step", "model": "hifigan_v1 + mpd + msd",
             "B": GAN_B, "segment": seg, "dtype": dname, "ms": t_step["median"], "ms_p25": t_step["p25"],
             "ms_p75": t_step["p75"], "n": t_step["n"], **summary})
        del state, step
    del corpus

    # iii. a registry optimizer through bin.train: the EFTS-Transformer's yaml
    # with AdamW and cosine annealing, 2 steps and a resume to 3
    reg_flash = registry_optimizer_phase(torch, trained, dev)

    # iv. the DurationModel at the JAX package's default widths
    duration_model_phase(torch, dev)
    return reg_flash


def registry_optimizer_phase(torch, trained, dev):
    """4o-iii: the first step of the EFTS-Transformer at its yaml's widths
    under AdamW + CosineAnnealingLR on the card against the CPU (B=2): the
    loss and the whole gradient, and the card's update against the CPU's
    rule and schedule on the card's gradient; then the training CLI with that
    optimizer: 2 steps, then a resume to 3, its flash launches returned."""
    from efficient_tts_tpu_torch import compat, init
    from efficient_tts_tpu_torch.bin import train
    from efficient_tts_tpu_torch.ops import flash_attention as fa
    from efficient_tts_tpu_torch.train.efts_train_step import make_train_step
    from efficient_tts_tpu_torch.train.optim import optimizer_from_dict
    from efficient_tts_tpu_torch.train.state import create_state, named_params
    from efficient_tts_tpu_torch.utils.config import load_config, model_config_from_dict

    configs = os.path.join(os.path.dirname(os.path.abspath(__file__)), "efficient_tts_tpu_torch", "configs")
    yaml_path = os.path.join(configs, "lj_efts_transformer_phnseq.yaml")
    config = {**load_config(yaml_path), **REGISTRY_OPTIMIZER}
    cfg = dataclasses.replace(model_config_from_dict(config), dropout_rate=0.0, num_symbols=148)
    params = init.init_efts_transformer(5, cfg)
    batch = train_batch(np.random.default_rng(5), cfg.num_symbols, cfg.odim)
    batch = {k: v[:2] for k, v in batch.items()}
    runs = {}
    for key, dname in (("card", dev), ("cpu", torch.device("cpu"))):
        model = compat.efts_transformer_from_jax(params, cfg, device=dname, trainable=True)
        tx = optimizer_from_dict(config)
        state = create_state(model, tx)
        before = {n: p.detach().clone() for n, p in named_params(model).items()}
        state, metrics = make_train_step(cfg, tx, device=dname)(state, batch)
        runs[key] = (before, {n: p.detach().clone() for n, p in named_params(model).items()}, state["opt_state"])
        runs[key + "_loss"] = float(metrics["loss"])
        del model, state
    # the model in the large: the loss and the whole gradient (from the first
    # moment); the attention's alignment path (text key, mel prenet: sigma
    # 0.01) moves several percent leafwise at B=2 under the flash kernels' TF32
    tx_parts = optimizer_from_dict(config).parts  # clip, AdamW at lr 1, the schedule
    rule, sched = tx_parts[1], tx_parts[2]
    (before_c, after_c, st_c), (_, _, st_h) = runs["card"], runs["cpu"]
    g_card = {n: m / (1 - rule.b1) for n, m in st_c[1]["m"].items()}
    num = sum(float((g_card[n].cpu() - m / (1 - rule.b1)).double().square().sum()) for n, m in st_h[1]["m"].items())
    den = sum(float((m / (1 - rule.b1)).double().square().sum()) for m in st_h[1]["m"].values())
    grad_rel = math.sqrt(num / den)
    # the optimizer: the card step's update against the CPU's registry rule and
    # schedule on the card's (clipped) gradient, added in f32 on the CPU
    cpu_params = {n: p.cpu() for n, p in before_c.items()}
    u, _ = rule.update({n: g.cpu() for n, g in g_card.items()}, rule.init(cpu_params), cpu_params)
    u, _ = sched.update(u, sched.init(cpu_params), cpu_params)
    upd_worst = (0.0, "")
    for n, p in cpu_params.items():
        err = (after_c[n].cpu() - (p + u[n])).abs()
        bound = UPDATE_TOL["update_rel"] * u[n].abs() + 2.0**-22 * p.abs() + 1e-12
        upd_worst = max(upd_worst, (float((err / bound).max()), n))
    loss_err = abs(runs["card_loss"] - runs["cpu_loss"]) / abs(runs["cpu_loss"])
    log({"phase": "train_card_vs_cpu", "model": "efts_transformer", "optimizer": REGISTRY_OPTIMIZER, "B": 2,
         "loss": runs["card_loss"], "loss_cpu": runs["cpu_loss"], "grad_rel_l2": grad_rel,
         "update_vs_cpu_rule_err_over_bound": upd_worst, "lr_at_step_0": sched.schedule(0),
         "tolerance": {"loss_rel": TRAIN_TOL["loss_rel"], "grad_rel_l2": UPDATE_TOL["grad_leaf_rel_l2"],
                       "update": "1e-3 of the update + 2^-22 of the parameter"}})
    if loss_err > TRAIN_TOL["loss_rel"] or grad_rel > UPDATE_TOL["grad_leaf_rel_l2"] or upd_worst[0] > 1.0:
        raise AssertionError(f"the registry optimizer's first step on the card disagrees with the CPU: loss "
                             f"{loss_err}, gradient {grad_rel}, update {upd_worst}")
    del runs

    corpus = trained["corpus"]
    sets = [f"dataset_params.wav_path={corpus['wavs']}", "model_params.dropout_rate=0.0", "text_bucket=128",
            "mel_bucket=128", "dataset_params.use_phnseq=false", "model_params.num_symbols=148",
            "log_interval_steps=1", *(f"{k}={json.dumps(v)}" for k, v in REGISTRY_OPTIMIZER.items())]
    out = os.path.join(trained["work"], "exp_tr_registry")
    args = ["--config", yaml_path, "--train_fid_scp", corpus["train"], "--outdir", out,
            *[a for o in sets for a in ("--set", o)], *(["--use_cpu"] if dev.type == "cpu" else [])]
    fa.reset_launches()
    first = train.main([*args, "--set", "train_max_steps=2", "--set", "save_interval_steps=2"])
    torch.cuda.synchronize()
    first_losses, first_lr_state = [m["loss"] for m in first.metrics_log], first.state["opt_state"][2]["count"]
    del first
    resumed = train.main([*args, "--set", "train_max_steps=3", "--set", "save_interval_steps=100"])
    torch.cuda.synchronize()
    reg_flash = dict(fa.launches)
    per_kernel = {k: sum(n for (kern, *_), n in reg_flash.items() if kern == k) for k in ("fwd", "dkv", "dq")}
    calls = cfg.n_text_encoder_layer + cfg.n_mel_encoder_layer + cfg.n_decoder_layer
    log({"phase": "main_path", "what": "bin.train, EFTS-Transformer, registry optimizer",
         "optimizer": REGISTRY_OPTIMIZER, "losses": first_losses + [m["loss"] for m in resumed.metrics_log],
         "resumed_steps": [r["step"] for r in resumed.step_times], "schedule_count_at_save": first_lr_state,
         "schedule_count_after_resume": resumed.state["opt_state"][2]["count"], "flash_launches": keyed(reg_flash)})
    if (resumed.state["step"] != 3 or [r["step"] for r in resumed.step_times] != [3] or first_lr_state != 2
            or resumed.state["opt_state"][2]["count"] != 3 or per_kernel != {k: 3 * calls for k in per_kernel}
            or not all(math.isfinite(v) for v in first_losses + [m["loss"] for m in resumed.metrics_log])):
        raise AssertionError(f"the registry optimizer through bin.train: steps {resumed.state['step']}, flash "
                             f"{reg_flash}")
    del resumed
    return reg_flash


def duration_model_phase(torch, dev):
    """4o-iv: the DurationModel at the JAX package's default widths (idim 256,
    256 channels, 2 layers) with a speaker table: the first step on the card
    against the CPU (dropout 0), a 50-step fit at the default dropout 0.1,
    `inference`'s rounded durations, one step timed and profiled."""
    from efficient_tts_tpu_torch.bench import time_ms
    from efficient_tts_tpu_torch.models.duration_model import DurationModelConfig
    from efficient_tts_tpu_torch.train.duration_train_step import init_duration_state, make_duration_train_step
    from efficient_tts_tpu_torch.train.optim import AdamWarmup

    cfg = DurationModelConfig(num_spks=8, spk_embed_dim=64)
    rng = np.random.default_rng(6)
    ppg = rng.standard_normal((DUR_B, DUR_T, cfg.idim)).astype(np.float32)
    lengths = rng.integers(DUR_T // 2, DUR_T + 1, DUR_B).astype(np.int32)
    lengths[0] = DUR_T
    batch = {"ppg": ppg, "lengths": lengths,
             "durations": np.clip(np.abs(ppg[:, :, 0] * 3) + 1, 1, 8).astype(np.int32),
             "spkids": rng.integers(0, cfg.num_spks, DUR_B).astype(np.int32)}
    first_cfg = dataclasses.replace(cfg, duration_predictor_dropout_rate=0.0)
    runs, losses = {}, {}
    for key, dname in (("card", dev), ("cpu", torch.device("cpu"))):
        tx = AdamWarmup(lr=1e-3, warmup_steps=None)
        state = init_duration_state(7, first_cfg, tx, device=dname)
        before = {n: p.detach().clone() for n, p in state["params"].named_parameters()}
        state, m = make_duration_train_step(first_cfg, tx, device=dname)(state, batch)
        runs[key] = (before, {n: p.detach().clone() for n, p in state["params"].named_parameters()},
                     state["opt_state"])
        losses[key] = float(m["loss"])
    grad_worst, upd_worst, fails = first_update_vs_cpu(torch, runs, lambda s: s["mu"], 0.9)
    loss_err = abs(losses["card"] - losses["cpu"]) / abs(losses["cpu"])

    tx = AdamWarmup(lr=1e-2, warmup_steps=None, weight_decay=0.0)
    state = init_duration_state(8, cfg, tx, device=dev)
    step = make_duration_train_step(cfg, tx, device=dev)
    dev_batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    fit = []
    for _ in range(DUR_STEPS):
        state, m = step(state, dev_batch)
        fit.append(m["loss"])
    fit = [float(x) for x in fit]
    pred = state["params"].inference(dev_batch["ppg"], dev_batch["spkids"]).cpu()
    t_step = time_ms(lambda: step(state, dev_batch), iters=20)
    prof = device_profile(torch, lambda: step(state, dev_batch))
    summary = profile_summary(prof, t_step["median"], ()) if prof else {"device_busy_ms": "not measured"}
    log({"phase": "train_card_vs_cpu", "model": "duration_model", "widths": "DurationModelConfig defaults",
         "num_spks": cfg.num_spks, "spk_embed_dim": cfg.spk_embed_dim, "B": DUR_B, "T": DUR_T,
         "loss": losses["card"], "loss_cpu": losses["cpu"], "worst_gradient_leaf_rel_l2": grad_worst,
         "worst_update_rel": upd_worst, "failing": fails[:5], "tolerance": UPDATE_TOL})
    log({"phase": "main_path", "what": "train.duration_train_step, DurationModel", "steps": DUR_STEPS,
         "loss_first": fit[0], "loss_last": fit[-1], "losses_every_10": fit[::10],
         "inference_shape": list(pred.shape), "inference_integers": bool(torch.equal(pred, torch.round(pred))),
         "step_ms": t_step["median"], "step_ms_p25": t_step["p25"], "step_ms_p75": t_step["p75"], **summary})
    if (fails or loss_err > 1e-5 or not fit[-1] < 0.5 * fit[0] or not all(math.isfinite(x) for x in fit)
            or tuple(pred.shape) != (DUR_B, DUR_T) or not torch.equal(pred, torch.round(pred))
            or (pred < 0).any()):
        raise AssertionError(f"the DurationModel: first step loss {loss_err}, {fails[:5]}, fit {fit[0]} -> "
                             f"{fit[-1]}, inference {tuple(pred.shape)}")


def build_tree(path):
    """Compile `path`'s flash_attention.cu, mrf_stage_int8.cu and
    probe_matmul.cu (their headers beside them) with the port's nvcc flags
    into path/_build, in parallel; {name: ctypes.CDLL}."""
    import ctypes
    import subprocess

    from efficient_tts_tpu_torch import _build

    os.makedirs(os.path.join(path, "_build"), exist_ok=True)
    jobs = {}
    for name in BASELINE_SOURCES:
        so = os.path.join(path, "_build", name + ".so")
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-o", so, os.path.join(path, name + ".cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {path}/{name}.cu:\n{out}")
        libs[name] = ctypes.CDLL(so)
    return libs


def baseline_phase(torch, path, dev):
    """An earlier tree's flash forward, W8A8 stage and matmul probe against
    this tree's, timed in turns (earlier, this, this, earlier) in this
    process."""
    import ctypes

    from efficient_tts_tpu_torch.bench import mrf_fused as bench_mrf
    from efficient_tts_tpu_torch.bench import time_ms
    from efficient_tts_tpu_torch.ops import flash_attention as fa
    from efficient_tts_tpu_torch.ops import mrf_int8

    t0 = time.perf_counter()
    libs = build_tree(path)
    log({"phase": "baseline", "what": "build", "tree": path, "seconds": time.perf_counter() - t0})
    real_lib = fa._lib
    new_fa = real_lib()
    old_fa = libs["flash_attention"]
    old_fa.flash_attention_fwd.argtypes = new_fa.flash_attention_fwd.argtypes
    old_fa.flash_attention_fwd.restype = ctypes.c_int
    order = ("earlier", "this", "this", "earlier")
    for name, fb, t, segmented in FLASH_FWD_SHAPES:
        q, k, v, seg = flash_inputs(torch, t, seed=t, dev=dev, segmented=segmented, b=fb)
        training = fb == TRAIN_B

        def run():
            return fa._forward_kernel(q, k, v, seg, 96**-0.5, residuals=training)

        times, queued, hosts, outs = {"earlier": [], "this": []}, {"earlier": [], "this": []}, {"earlier": [], "this": []}, {}
        try:
            for tree in order:
                # both libraries take the same C interface: the wrapper is the same
                fa._lib = (lambda: old_fa) if tree == "earlier" else real_lib
                outs[tree] = run()
                per_launch = launch_ms(torch, run, (FLASH_KERNELS["fwd"],)).get(FLASH_KERNELS["fwd"])
                times[tree].append(per_launch[0] if per_launch else None)
                queued[tree].append(queued_ms(torch, run))
                hosts[tree].append(host_us(torch, run))
        finally:
            fa._lib = real_lib
        a, b_ = (outs["earlier"][0], outs["this"][0]) if training else (outs["earlier"], outs["this"])
        log({"phase": "baseline", "what": "flash_attention_fwd_" + name, "shape": list(q.shape),
             "segment_ids": segmented, "residuals": training, "order": order,
             "earlier_ms": times["earlier"], "this_ms": times["this"],
             "earlier_queued_ms": queued["earlier"], "this_queued_ms": queued["this"],
             "earlier_host_us": hosts["earlier"], "this_host_us": hosts["this"],
             "this_vs_earlier": err_stats(b_, a)})
        del q, k, v, seg, outs
    # the earlier tree's W8A8 library takes this tree's C interface (the
    # weights' tensor maps), so the same wrapper drives it
    old_int8 = libs["mrf_stage_int8"]
    real_int8 = mrf_int8._lib
    for fn in ("mrf_conv_int8", "mrf_absmax", "mrf_int8_weight_map"):
        getattr(old_int8, fn).argtypes = getattr(real_int8(), fn).argtypes
        getattr(old_int8, fn).restype = ctypes.c_int
    c, t = INT8_SHAPES[-1]
    st = bench_mrf.make_stage(B, t * c // bench_mrf.LANES, c, dev)
    kw = mrf_int8.kernel_weights(st["wq"])

    def earlier_stage(act):
        mrf_int8._lib = lambda: old_int8
        try:
            return mrf_int8.mrf_stage_int8(st["x"], kw, st["scales"], st["biases"], (3, 7, 11), ((1, 3, 5),) * 3, act)
        finally:
            mrf_int8._lib = real_int8

    for kind, act in (("dynamic", None), ("static", st["act_scales"])):
        fns = {"earlier": lambda: earlier_stage(act),
               "this": lambda: mrf_int8.mrf_stage_int8(st["x"], kw, st["scales"], st["biases"], (3, 7, 11),
                                                       ((1, 3, 5),) * 3, act)}
        times = {"earlier": [], "this": []}
        for tree in order:
            times[tree].append(time_ms(fns[tree])["median"])
        equal = bool(torch.equal(fns["earlier"](), fns["this"]()))
        log({"phase": "baseline", "what": f"mrf_stage_int8_{kind}_c{c}", "shape": [B, t, c], "order": order,
             "earlier_ms": times["earlier"], "this_ms": times["this"], "outputs_equal": equal})
        if not equal:
            raise AssertionError(f"the W8A8 stage of {path} and of this tree differ ({kind} scales)")
    del st, kw
    # the matmul probe: both libraries take the same C interface
    from efficient_tts_tpu_torch.bench import probe_int8 as bench_probe
    from efficient_tts_tpu_torch.ops import probe_matmul as pm

    old_pm = libs["probe_matmul"]
    old_pm.probe_matmul.argtypes = pm._lib().probe_matmul.argtypes
    old_pm.probe_matmul.restype = ctypes.c_int
    real_pm = pm._lib
    times = {}
    for name, (x, w) in bench_probe.make_inputs(bench_probe.M, dev).items():
        times[name], outs = {"earlier": [], "this": []}, {}
        try:
            for tree in order:
                pm._lib = (lambda: old_pm) if tree == "earlier" else real_pm
                outs[tree] = pm.probe_matmul(x, w)
                times[name][tree].append(time_ms(lambda: pm.probe_matmul(x, w))["median"])
        finally:
            pm._lib = real_pm
        stats = err_stats(outs["this"], outs["earlier"])
        log({"phase": "baseline", "what": f"probe_matmul_{name}", "shape": list(x.shape), "order": order,
             "earlier_ms": times[name]["earlier"], "this_ms": times[name]["this"], "this_vs_earlier": stats})
        if name == "int8" and stats["max_abs_err"] != 0.0:
            raise AssertionError(f"the int8 probe of {path} and of this tree differ: {stats}")
        del x, w, outs
    ratio = {tree: [b_ / i_ for b_, i_ in zip(times["bf16"][tree], times["int8"][tree])] for tree in ("earlier", "this")}
    log({"phase": "baseline", "what": "probe_matmul int8:bf16 rate ratio", "earlier": ratio["earlier"],
         "this": ratio["this"]})


def wav_dirs_diff(a_dir, b_dir, names):
    """(whether each named wav is byte-equal in the two directories, the
    largest PCM difference between them)."""
    from scipy.io import wavfile

    same, worst = True, 0
    for name in names:
        a, b = os.path.join(a_dir, name), os.path.join(b_dir, name)
        with open(a, "rb") as fa_, open(b, "rb") as fb_:
            same = same and fa_.read() == fb_.read()
        pa, pb = wavfile.read(a)[1].astype(np.int32), wavfile.read(b)[1].astype(np.int32)
        worst = max(worst, int(np.abs(pa - pb).max()) if pa.shape == pb.shape else 1 << 16)
    return same, worst


def reference_io_phase(torch, stages, new_launches, voc, trained, synth, device="cuda"):
    """4p: the reference's file formats and the tooling on 4m's EFTS-CNN
    checkpoint and 4n's vocoder checkpoint: an EFTS-CNN round trip through
    `bin.export_torch` and `bin.convert_checkpoint`, the EMA generator
    exported weight-normed and folded, each then through `bin.inference`
    (wavs byte-equal to 4n-iv's, 72 f32 MRF launches a run); the `g_`/`do_`
    pair read back into the discriminators (outputs and feature maps
    bit-equal on one batch); `utils.profiling.time_step` of `synth` and a
    `trace` around it; 4m's eval images. `voc` is what 4n returns, `trained`
    what 4m returns. Returns time_step's ms for phase 5 to print beside its
    own. `device` is the card; "cpu" rehearses the phase at a small config."""
    import shutil

    from efficient_tts_tpu_torch.bin import convert_checkpoint, export_torch, inference
    from efficient_tts_tpu_torch.compat import torch_import
    from efficient_tts_tpu_torch.data.collate import collate_mel_audio
    from efficient_tts_tpu_torch.data.dataset import MelAudioSegmentDataset, load_filepaths_and_text
    from efficient_tts_tpu_torch.models.hifigan_train import Discriminators, HiFiGANTrainGenerator
    from efficient_tts_tpu_torch.ops import mrf
    from efficient_tts_tpu_torch.train.checkpoint import read_checkpoint
    from efficient_tts_tpu_torch.train.hifigan_train_step import batch_to_device
    from efficient_tts_tpu_torch.utils import plotting, profiling

    dev = torch.device(device)
    cpu = ["--use_cpu"] if dev.type == "cpu" else []
    t_phase = time.perf_counter()
    cnn_ckpt, voc_ckpt = trained["cnn_checkpoint"], voc["checkpoint"]
    root = os.path.join(voc["work"], "reference_io")
    names = [os.path.splitext(os.path.basename(p))[0] + "_gen.wav"
             for p, _ in load_filepaths_and_text(voc["test_scp"])]
    want_launches = stage_launches(stages, "f32", 1)

    def infer(tag, checkpoint, vocoder):
        out = os.path.join(root, tag)
        mrf.reset_launches()
        inference.main([*cpu, "--test_fid_scp", voc["test_scp"], "--checkpoint", checkpoint, "--outdir", out,
                        "--batch_size", "8", "--vocoder_checkpoint", vocoder])
        launches = new_launches[f"reference_io_{tag}", "f32"] = dict(mrf.launches)
        return (*wav_dirs_diff(out, voc["wavs_vocoder"], names), launches)

    # i. EFTS-CNN: the port's checkpoint -> the reference's .pkl -> the port's
    # checkpoint (the config copied beside it), then the inference CLI
    cnn_config = os.path.join(os.path.dirname(cnn_ckpt), "config.yml")
    pkl = os.path.join(root, "efts_cnn.pkl")
    os.makedirs(root, exist_ok=True)
    export_torch.main(["--checkpoint", cnn_ckpt, "--out", pkl])
    converted = convert_checkpoint.main(["--torch_checkpoint", pkl, "--outdir", os.path.join(root, "converted"),
                                         "--config", cnn_config])
    shutil.copy(cnn_config, os.path.dirname(converted))
    before, after = read_checkpoint(cnn_ckpt)["params"], read_checkpoint(converted)
    params_equal = sorted(before) == sorted(after["params"]) and all(torch.equal(v, after["params"][k])
                                                                    for k, v in before.items())
    same, pcm_diff, launches = infer("efts_cnn_round_trip", converted, voc_ckpt)
    log({"phase": "reference_io", "what": "EFTS-CNN: bin.export_torch -> bin.convert_checkpoint -> bin.inference",
         "checkpoint": os.path.basename(cnn_ckpt), "pkl_tensors": len(torch.load(pkl, weights_only=False)["model"]),
         "converted": os.path.basename(converted), "step": after["step"], "params_bit_equal": params_equal,
         "wavs": len(names), "wavs_byte_equal_to_4n_iv": same, "max_pcm_diff": pcm_diff,
         "mrf_launches": keyed(launches)})
    if not params_equal or after["step"] != 14 or not same or launches != want_launches:
        raise AssertionError(f"the EFTS-CNN round trip: params equal {params_equal}, step {after['step']}, "
                             f"wavs equal {same} (PCM diff {pcm_diff}), launches {launches}")
    del before, after

    # ii. the EMA generator as the reference's generator file, weight-normed
    # and folded, each the inference CLI's vocoder
    for fold in (False, True):
        tag = "generator_folded" if fold else "generator_weight_normed"
        out_dir = os.path.join(root, tag)
        os.makedirs(out_dir, exist_ok=True)
        shutil.copy(os.path.join(os.path.dirname(voc_ckpt), "config.yml"), out_dir)
        gen_file = os.path.join(out_dir, "generator_v1")
        export_torch.main(["--model", "HiFiGANGenerator", "--checkpoint", voc_ckpt, "--out", gen_file, "--ema",
                           *(["--fold_weight_norm"] if fold else [])])
        keys = torch.load(gen_file, weights_only=False)["generator"]
        same, pcm_diff, launches = infer(tag, cnn_ckpt, gen_file)
        weight_v = sum(k.endswith("weight_v") for k in keys)
        log({"phase": "reference_io", "what": f"bin.export_torch --model HiFiGANGenerator --ema"
             f"{' --fold_weight_norm' if fold else ''} -> bin.inference", "tensors": len(keys),
             "weight_v_keys": weight_v, "wavs": len(names), "wavs_byte_equal_to_4n_iv": same,
             "max_pcm_diff": pcm_diff, "mrf_launches": keyed(launches)})
        if not same or launches != want_launches or (weight_v == 0) != fold:
            raise AssertionError(f"the {tag} file through the inference CLI: wavs equal to 4n-iv's {same} (PCM "
                                 f"diff {pcm_diff}), launches {launches}")

    # iii. the official recipe's g_/do_ pair; MPD and MSD read back onto the card
    full = os.path.join(root, "full")
    g_path, do_path = export_torch.main(["--model", "HiFiGANFull", "--checkpoint", voc_ckpt, "--out", full])
    do = torch.load(do_path, weights_only=False)
    saved = read_checkpoint(voc_ckpt)
    orig = Discriminators()
    orig.load_state_dict(saved["disc"]["params"])
    orig.to(dev)
    mpd = torch_import.hifigan_mpd_from_state_dict(do["mpd"], device=dev)
    msd = torch_import.hifigan_msd_from_state_dict(do["msd"], device=dev)
    gen = HiFiGANTrainGenerator(voc["voc_cfg"])
    gen.load_state_dict(saved["ema"])
    gen.to(dev)
    del saved
    ds = MelAudioSegmentDataset(voc["wavs"]["dev"], segment_size=voc["voc_cfg"].segment_size, shuffle=False)
    batch = batch_to_device(collate_mel_audio([ds[i] for i in range(min(GAN_B, len(ds)))]), dev)
    uv_equal = all(torch.equal(a.u, b.u) and torch.equal(a.v, b.v)
                   for a, b in zip(msd.discriminators[0].convs, orig.msd.discriminators[0].convs))
    outputs, mismatched = 0, []
    with torch.no_grad():
        y, y_hat = batch["audio"], gen(batch["mel"])
        for name, a, b in (("mpd", mpd, orig.mpd), ("msd", msd, orig.msd)):
            for fused in (False, True):
                got, want = a(y, y_hat, fused=fused), b(y, y_hat, fused=fused)
                flat_got = [t for part in got for item in part for t in (item if isinstance(item, list) else [item])]
                flat_want = [t for part in want for item in part for t in (item if isinstance(item, list) else [item])]
                outputs += len(flat_want)
                mismatched += [(name, fused, i) for i, (p, q) in enumerate(zip(flat_got, flat_want))
                               if not torch.equal(p, q)]
    log({"phase": "reference_io", "what": "bin.export_torch --model HiFiGANFull -> compat.torch_import MPD, MSD",
         "files": [os.path.basename(g_path), os.path.basename(do_path)], "steps": do["steps"], "epoch": do["epoch"],
         "batch": list(batch["audio"].shape), "outputs_and_feature_maps": outputs, "mismatched": mismatched[:5],
         "sn_u_v_equal": uv_equal})
    if mismatched or not uv_equal or do["steps"] != 12 or not outputs:
        raise AssertionError(f"the g_/do_ pair read back: mismatched {mismatched[:5]}, u and v equal {uv_equal}")
    del mpd, msd, orig, gen, batch, do

    # iv. utils.profiling: time_step of the synthesis (phase 5 times the same
    # call with CUDA events a call and prints it beside), and a trace of one
    step_s = profiling.time_step(synth, iters=N_TIMED, warmup=2, device=dev)
    trace_dir = os.path.join(root, "trace")
    with profiling.trace(trace_dir):
        synth()
        if dev.type == "cuda":
            torch.cuda.synchronize()
    (trace_file,) = os.listdir(trace_dir)
    with open(os.path.join(trace_dir, trace_file)) as f:
        trace_text = f.read()
    names_mrf = MRF_KERNELS["f32"] in trace_text
    log({"phase": "reference_io", "what": "utils.profiling", "time_step_ms": 1e3 * step_s,
         "trace_mb": len(trace_text) / 2**20, "trace_names_mrf_kernel": names_mrf})
    if not names_mrf and dev.type == "cuda":
        raise AssertionError(f"the trace {trace_file} does not name {MRF_KERNELS['f32']}")

    # v. 4m's eval images (the trainer draws them only where matplotlib is installed)
    images_dir = os.path.join(os.path.dirname(cnn_ckpt), "images")
    images = sorted(os.listdir(images_dir)) if os.path.isdir(images_dir) else []
    if plotting.available():
        log({"phase": "reference_io", "what": "EftsTrainer eval images", "images": len(images),
             "kinds": sorted({n.rsplit("_", 1)[1] for n in images})})
        if not images or len(images) % 3:
            raise AssertionError(f"4m's evals drew {images}")
    else:
        log({"phase": "reference_io", "what": "EftsTrainer eval images", "matplotlib": "absent",
             "images": len(images)})
        if images:
            raise AssertionError(f"images without matplotlib: {images}")
    log({"phase": "reference_io", "what": "phase 4p", "seconds": time.perf_counter() - t_phase})
    return 1e3 * step_s


# ---------------------------------------------------------------------------
# 4q. multi-rank synthesis and serving: each rank is a process of this script
# (`--rank_task`), all on the one card

# JAX's bound for sharded synthesis against one device (tests/test_sharded_synthesis.py)
MR_TOL = {"atol": 2e-5, "rtol": 1e-4}
MR_MODES = ("dp", "tp", "sp", "dp+tp", "dp+sp")
# the two-rank meshes of 4q-ii
MR_MESHES = {"dp": (2, 1), "sp": (1, 2), "tp": (1, 2)}
# what the ranks' engine serves; 4q-iii's HTTP texts
MR_TEXTS = ("Hello there.", "A much longer sentence to synthesize, really.", "Hi.",
            "The quick brown fox jumps over the dog.")


def start_ranks(task, world, work, backend):
    """`world` processes of this script running rank task `task`, joined
    through a file:// rendezvous in `work`; each writes its log and report there."""
    import subprocess

    procs, logs = [], []
    for r in range(world):
        logs.append(os.path.join(work, f"{task}.rank{r}.log"))
        with open(logs[-1], "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--rank_task", task, "--rank", str(r), "--world",
                 str(world), "--init", f"file://{work}/{task}.rdv", "--out", work, "--backend", backend],
                stdout=f, stderr=subprocess.STDOUT))
    return procs, logs


def wait_ranks(procs, logs, timeout=300):
    """Wait for every rank; when one fails or the time runs out, kill them
    all and raise with the end of each log."""
    deadline = time.monotonic() + timeout
    while any(p.poll() is None for p in procs):
        if time.monotonic() > deadline or any(p.poll() not in (None, 0) for p in procs):
            for p in procs:
                p.kill()
            break
        time.sleep(0.1)
    rcs = [p.wait(timeout=60) for p in procs]
    if rcs != [0] * len(procs):
        tails = "\n".join(f"--- {path} ---\n{open(path).read()[-6000:]}" for path in logs)
        raise AssertionError(f"ranks exited {rcs}:\n{tails}")


def launch_list(launches):
    return [[*k, n] for k, n in launches.items()]


def param_bytes(module, names):
    named = {**dict(module.named_parameters()), **dict(module.named_buffers())}
    return sum(named[n].numel() * named[n].element_size() for n in names)


def rank_main(opts) -> int:
    """One rank of 4q: `one_rank` (a world of one under NCCL) or `two_ranks`
    (gloo, both ranks on card 0). Writes its report lines to
    `<out>/<task>.rank<r>.json`; a failed check raises."""
    import torch
    import torch.distributed as dist

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from efficient_tts_tpu_torch import _build, compat, init, pipeline
    from efficient_tts_tpu_torch.bench import serving_load
    from efficient_tts_tpu_torch.models.efficient_tts import EftsCNNConfig
    from efficient_tts_tpu_torch.models.efficient_tts_transformer import EftsTransformerConfig
    from efficient_tts_tpu_torch.models.hifigan import HiFiGANConfig
    from efficient_tts_tpu_torch.ops import flash_attention as fa
    from efficient_tts_tpu_torch.ops import mrf
    from efficient_tts_tpu_torch.parallel import initialize_multihost, make_mesh, param_specs, rank_device, \
        shard_module
    from efficient_tts_tpu_torch.serve import TTSEngine

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # the parent built the kernels: a rank loads them and builds none
    for name in ("mrf_stage", "flash_attention"):
        if not _build._target(_build.SRC_DIR / f"{name}.cu").exists():
            raise AssertionError(f"csrc/{name}.cu is not built: run the ranks from chip_smoke.py's phase 4q")
    # one card: every rank runs on card 0, by name
    dev = rank_device("cuda", index=0)
    torch.cuda.set_device(dev)
    initialize_multihost(opts.init, opts.world, opts.rank, backend=opts.backend, device="cuda")
    rank, lines = dist.get_rank(), []

    def report(**line):
        lines.append({"rank": rank, "world": opts.world, "backend": dist.get_backend(), **line})

    voc_cfg = HiFiGANConfig()
    efts_cfg = EftsCNNConfig(num_symbols=76, dropout_rate=0.0, use_masking=True)
    stages = [(voc_cfg.upsample_initial_channel // 2 ** (i + 1), 0) for i in range(len(voc_cfg.upsample_rates))]
    efts = compat.efts_cnn_from_jax(init.init_efts(0, efts_cfg), efts_cfg, device=dev)
    voc = compat.hifigan_generator_from_jax(init.init_generator(1, voc_cfg), voc_cfg, device=dev)
    batches = ragged_batches(np.random.default_rng(0), T1, efts_cfg.num_symbols)
    text, lengths = batches[0]

    if opts.rank_task == "one_rank":
        # every mode and synthesize(mesh=) on a (1, 1) mesh: bit-equal to one
        # card, with 4a's MRF launches
        mesh = make_mesh(1, 1)
        for dname, cdt in (("f32", None), ("bf16", torch.bfloat16)):
            ref = pipeline.synthesize_fixed(efts, voc, text, lengths, T2, compute_dtype=cdt, device=dev)
            for mode in MR_MODES:
                mrf.reset_launches()
                got = pipeline.synthesize_fixed_sharded(efts, voc, text, lengths, T2, mesh, mode=mode,
                                                        compute_dtype=cdt, device=dev)
                torch.cuda.synchronize()
                launches, want = dict(mrf.launches), stage_launches(stages, dname, 1)
                equal = all(torch.equal(a, b) for a, b in zip(got, ref))
                report(what="synthesize_fixed_sharded", mode=mode, mesh=[1, 1], dtype=dname, bit_equal=equal,
                       mrf_launches=launch_list(launches), expected=launch_list(want))
                if not equal or launches != want:
                    raise AssertionError(f"{mode} {dname} on (1, 1): bit-equal {equal}, launches {launches}")
            mrf.reset_launches()
            got = [pipeline.synthesize(efts, voc, t, n, compute_dtype=cdt, device=dev, mesh=mesh) for t, n in batches]
            launches, want = dict(mrf.launches), stage_launches(stages, dname, len(batches))
            refs = [pipeline.synthesize(efts, voc, t, n, compute_dtype=cdt, device=dev) for t, n in batches]
            equal = all(np.array_equal(a, b) for g, r in zip(got, refs) for a, b in zip(g, r))
            report(what="synthesize(mesh=)", mesh=[1, 1], dtype=dname, batches=len(batches), bit_equal=equal,
                   buckets=[int(w.shape[1] // voc_cfg.hop_size) for w, _ in got],
                   mrf_launches=launch_list(launches), expected=launch_list(want))
            if not equal or launches != want:
                raise AssertionError(f"synthesize(mesh=) {dname}: bit-equal {equal}, launches {launches}")
    elif opts.rank_task == "two_ranks":
        meshes = {shape: make_mesh(*shape) for shape in sorted(set(MR_MESHES.values()))}
        torch.cuda.reset_peak_memory_stats(dev)
        ref = pipeline.synthesize_fixed(efts, voc, text, lengths, T2, device=dev)
        torch.cuda.synchronize()
        one_card_peak_mb = torch.cuda.max_memory_allocated(dev) / 2**20
        for mode, shape in MR_MESHES.items():
            mesh = meshes[shape]
            mrf.reset_launches()
            torch.cuda.reset_peak_memory_stats(dev)
            got = pipeline.synthesize_fixed_sharded(efts, voc, text, lengths, T2, mesh, mode=mode, device=dev)
            torch.cuda.synchronize()
            launches = dict(mrf.launches)
            # dp: one batch block a rank; sp: one window a rank; tp: no kernel takes a column slice
            want = {} if mode == "tp" else stage_launches(stages, "f32", 1)
            diff = {k: float((a.float() - b.float()).abs().max()) for k, a, b in zip(("wav", "wav_lengths", "mel"),
                                                                                    got, ref)}
            equal = all(torch.equal(a, b) for a, b in zip(got, ref))
            close = torch.equal(got[1], ref[1]) and all(torch.allclose(a, b, **MR_TOL) for a, b in
                                                        ((got[0], ref[0]), (got[2], ref[2])))
            line = dict(what="synthesize_fixed_sharded", mode=mode, mesh=list(shape), dtype="f32",
                        max_abs_diff=diff, bit_equal=equal, within=close, tolerance=MR_TOL,
                        k3_launches=launch_list(launches), expected=launch_list(want),
                        peak_mb=torch.cuda.max_memory_allocated(dev) / 2**20, one_card_peak_mb=one_card_peak_mb)
            # dp against one card on the rank's block of rows, bit for bit: at B=16
            # cuBLAS sums the f32 linears (text_value, mel_out) in another order
            # than at B=8, so the whole batch is held to JAX's tolerance
            exact = equal
            if mode == "dp":
                rows = slice(mesh.data_index * B // 2, (mesh.data_index + 1) * B // 2)
                block = pipeline.synthesize_fixed(efts, voc, text[rows], lengths[rows], T2, device=dev)
                exact = line["block_bit_equal"] = all(torch.equal(a[rows], b) for a, b in zip(got, block))
            if mode == "tp":
                for name, module in (("efts_cnn", efts), ("hifigan_v1", voc)):
                    sharded = [n for n, a in param_specs(module, mesh).items() if a is not None]
                    line[f"{name}_sharded_leaf_bytes"] = [param_bytes(module, sharded),
                                                          param_bytes(shard_module(module, mesh), sharded)]
            report(**line)
            # tp's column slices run cuDNN's convs where one card runs K3: JAX's tolerance
            if not close or launches != want or (mode != "tp" and not exact):
                raise AssertionError(f"{mode} over two ranks: {line}")
        # the EFTS-Transformer (4b's model) under dp, bf16, on the flash kernel
        tr_cfg = EftsTransformerConfig(num_symbols=76, dropout_rate=0.0, sigma=0.01, attn_impl="flash")
        tr_params = init.init_efts_transformer(2, tr_cfg)
        tr_params["duration_predictor"]["out"]["b"][:] = 1.3
        tr = compat.efts_transformer_from_jax(tr_params, tr_cfg, device=dev)
        tr_text, tr_lengths = ragged_batches(np.random.default_rng(1), T1_TR, tr_cfg.num_symbols)[0]
        ref = pipeline.synthesize_fixed(tr, voc, tr_text, tr_lengths, T2, compute_dtype=torch.bfloat16, device=dev)
        mrf.reset_launches()
        fa.reset_launches()
        got = pipeline.synthesize_fixed_sharded(tr, voc, tr_text, tr_lengths, T2, meshes[2, 1], mode="dp",
                                                compute_dtype=torch.bfloat16, device=dev)
        torch.cuda.synchronize()
        flash, launches = flash_by_segments(fa.launches), dict(mrf.launches)
        want_flash = {True: tr_cfg.n_text_encoder_layer, False: tr_cfg.n_decoder_layer}
        stats = err_stats(got[0], ref[0])
        rows = slice(meshes[2, 1].data_index * B // 2, (meshes[2, 1].data_index + 1) * B // 2)
        block = pipeline.synthesize_fixed(tr, voc, tr_text[rows], tr_lengths[rows], T2,
                                          compute_dtype=torch.bfloat16, device=dev)
        block_equal = all(torch.equal(a[rows], b) for a, b in zip(got, block))
        report(what="synthesize_fixed_sharded", model="efts_transformer", mode="dp", mesh=[2, 1], dtype="bf16",
               T1=T1_TR, bit_equal=all(torch.equal(a, b) for a, b in zip(got, ref)), block_bit_equal=block_equal,
               wav=stats, tolerance=WAV_TOL, flash_fwd_launches=[[seg, n] for seg, n in flash.items()],
               mrf_launches=launch_list(launches))
        if (flash != want_flash or launches != stage_launches(stages, "bf16", 1) or not block_equal
                or not torch.equal(got[1], ref[1]) or not within(stats, WAV_TOL)):
            raise AssertionError(f"the transformer under dp: flash {flash}, MRF {launches}, block {block_equal}, "
                                 f"{stats}")
        del tr
        # the engine over the two ranks against one rank's, on bench/serving_load.py's pinned weights
        cfg, params = serving_load.pinned_efts_params()
        model = compat.efts_cnn_from_jax(params, cfg, device=dev)
        mrf.reset_launches()
        wavs = TTSEngine(model, voc, device=dev, max_batch=SERVE_MAX_BATCH, mesh=meshes[2, 1]).synthesize(
            list(MR_TEXTS[:3]))
        launches = dict(mrf.launches)
        wants = TTSEngine(model, voc, device=dev, max_batch=SERVE_MAX_BATCH).synthesize(list(MR_TEXTS[:3]))
        diff = max(float(np.abs(a - b).max()) if a.shape == b.shape else math.inf for a, b in zip(wavs, wants))
        report(what="TTSEngine(mesh=)", mesh=[2, 1], dtype="f32", texts=3, max_abs_diff=diff,
               bit_equal=all(np.array_equal(a, b) for a, b in zip(wavs, wants)),
               samples=[len(w) for w in wavs], mrf_launches=launch_list(launches))
        if diff > 5e-5 or launches != stage_launches(stages, "f32", 1):
            raise AssertionError(f"the two-rank engine differs from one rank's by {diff}, launches {launches}")
    else:
        raise ValueError(f"unknown rank task {opts.rank_task!r}")
    with open(os.path.join(opts.out, f"{opts.rank_task}.rank{rank}.json"), "w") as f:
        json.dump(lines, f)
    dist.destroy_process_group()
    return 0


def multi_rank_phase(torch, new_launches, work):
    """4q: the multi-rank paths on the one card. i. a world of one under NCCL
    and ii. two ranks under gloo run at once, each in its own processes;
    then iii. `bin.serve --data_parallel 2` over two ranks under gloo.
    Returns the ranks' flash forward launches {path: {segmented: n}}."""
    import subprocess

    from efficient_tts_tpu_torch.bench import serving_load
    from efficient_tts_tpu_torch import compat
    from efficient_tts_tpu_torch.bin import serve as serve_cli
    from efficient_tts_tpu_torch.train.checkpoint import save_checkpoint

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    runs = [("one_rank", start_ranks("one_rank", 1, work, "nccl")),
            ("two_ranks", start_ranks("two_ranks", 2, work, "gloo"))]
    try:
        for _, (procs, logs) in runs:
            wait_ranks(procs, logs)
    finally:  # a failed world leaves the other's ranks to kill
        for _, (procs, _) in runs:
            for p in procs:
                p.kill()
    flash = {}
    for task, (procs, _) in runs:
        for r in range(len(procs)):
            with open(os.path.join(work, f"{task}.rank{r}.json")) as f:
                for line in json.load(f):
                    log({"phase": "multi_rank", **line})
                    tag = (f"multi_rank_{line['backend']}{line['world']}_{line.get('model', 'efts_cnn')}_"
                           f"{line.get('mode', line['what'])}" + (f"_rank{r}" if line["world"] > 1 else ""))
                    launches = line.get("mrf_launches", line.get("k3_launches"))
                    if launches is not None:
                        new_launches[tag, line["dtype"]] = {(d, c): n for d, c, n in launches}
                    if "flash_fwd_launches" in line:
                        flash[tag] = {seg: n for seg, n in line["flash_fwd_launches"]}
    t_iii = time.perf_counter()

    # iii. the server over two ranks on the one card, on a checkpoint of the
    # pinned EFTS-CNN (the vocoder: bin.serve's seeded V1)
    cfg, params = serving_load.pinned_efts_params()
    ckpt_dir = os.path.join(work, "served")
    ckpt = save_checkpoint(ckpt_dir, {"params": compat.efts_cnn_from_jax(params, cfg), "opt_state": None, "step": 1})
    with open(os.path.join(ckpt_dir, "config.yml"), "w") as f:
        json.dump({"model_name": "EfficientTTSCNN", "model_params": dataclasses.asdict(cfg)}, f)
    args = ["--checkpoint", ckpt, "--max_batch", "4"]
    logs, procs = [os.path.join(work, f"serve.rank{r}.log") for r in range(2)], []
    for r in range(2):
        with open(logs[r], "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "efficient_tts_tpu_torch.bin.serve", *args, "--data_parallel", "2",
                 "--coordinator_address", f"file://{work}/serve.rdv", "--num_processes", "2", "--process_id", str(r),
                 "--dist_backend", "gloo", "--device_index", "0", "--host", "127.0.0.1", "--port", "0"],
                stdout=f, stderr=subprocess.STDOUT, cwd=os.path.dirname(os.path.abspath(__file__))))
    try:
        port, deadline = None, time.monotonic() + 240
        while port is None:
            if time.monotonic() > deadline or any(p.poll() is not None for p in procs):
                raise AssertionError("bin.serve --data_parallel 2 did not start:\n"
                                     + "\n".join(open(path).read()[-6000:] for path in logs))
            found = [ln for ln in open(logs[0]).read().splitlines() if "serving on 127.0.0.1:" in ln]
            port = int(found[0].rsplit(":", 1)[1]) if found else time.sleep(0.2)
        t_ready = time.perf_counter()
        bodies = []
        for text in MR_TEXTS:
            status, body, _, secs = http_post(port, "/synthesize", text)
            if status != 200:
                raise AssertionError(f"bin.serve --data_parallel 2 answered {status}: {body[:200]}")
            bodies.append(wav_pcm(body))
        procs[0].send_signal(15)  # SIGTERM: rank 0 stops serving and releases rank 1
        rcs = [p.wait(timeout=120) for p in procs]
    finally:
        for p in procs:
            p.kill()
    if rcs != [0, 0] or "following" not in open(logs[1]).read():
        raise AssertionError(f"the ranks exited {rcs}:\n" + "\n".join(open(path).read()[-6000:] for path in logs))
    # the one-card server's waveforms: bin.serve's engine without --data_parallel
    engine = serve_cli.build_engine(serve_cli.get_parser().parse_args(args))
    wants = [np.round(np.clip(w, -1.0, 1.0) * 32767.0).astype(np.int16) for w in engine.synthesize(list(MR_TEXTS))]
    steps = [int(np.abs(a.astype(np.int32) - b).max()) if a.shape == b.shape else None for a, b in zip(bodies, wants)]
    log({"phase": "multi_rank", "what": "bin.serve --data_parallel 2", "backend": "gloo", "world": 2,
         "requests": len(bodies), "samples": [len(b) for b in bodies], "max_pcm_steps_vs_one_card_server": steps,
         "exit_codes": rcs, "start_s": t_ready - t_iii, "seconds": time.perf_counter() - t_iii})
    if any(s is None or s > 1 for s in steps):
        raise AssertionError(f"bin.serve over two ranks differs from one card's by {steps} PCM steps")
    del engine
    log({"phase": "multi_rank", "what": "phase 4q", "seconds": time.perf_counter() - t_phase})
    return flash


# 4r. training over ranks: each rank a process of this script (`--rank_task
# train_*`), all on the one card

# the CPU tests' bounds against one process (tests/test_torch_port_parallel_training.py):
# metrics; each first-moment leaf (the clipped, decayed gradient) within
# `mu` of its own max plus `mu_top` of the tree's; the updates, where that
# moment is above 1e-3 of its leaf's max and 1e-5 of the tree's, within
# `update` of the leaf's largest update plus 2 ulps of its largest parameter
# (the CPU tests take 1e-7 of the tree's max at B=8, T2=64; at B=128, T2=512
# a leaf's sums run over 128 times the frames, summed by rank then across
# ranks, and a leaf a thousandth of the largest, as the alignment's text key,
# moves by 1e-6 of the largest, as measured on one H100)
MRT_TOL = {"metric_rel": 1e-5, "mu": 1e-4, "mu_top": 1e-6, "update": 1e-4}
# (the EFTS-Transformer's step takes 4c's and 4o-iii's bounds instead:
# `mrt_compare_tf32`; on one H100 its dp+tp moments came up to
# 5.5 times these)
# the GAN's moments: the generator's gradient reaches the waveform through sums
# with heavy cancellation (gen), the discriminators' do not (disc); the
# generator's Adam update is a sign and is not compared
MRT_GAN_MU = {"gen": (1e-3, 2e-4), "disc": (1e-4, 1e-6)}
MRT_CNN_B = 128  # the EFTS-CNN yamls' batch
MRT_MODES = {"efts_cnn": ("dp", "tp", "sp"), "efts_transformer": ("dp", "tp", "sp"), "hifigan_v1": ("dp", "tp")}
MRT_MESHES = {"dp": (2, 1), "tp": (1, 2), "sp": (1, 2), "dp+tp": (2, 2), "dp+sp": (2, 2), "sp4": (1, 4)}
# each multi-rank task's world and modes: dp+tp and dp+sp take four ranks,
# and so does the transformer's sp over 4 ranks on the corpus's T2 = 640
# (`efts_transformer_t640`: 160 rows a rank, the kernels' padded rows)
MRT_WORLDS = {"train_two_ranks": (2, MRT_MODES),
              "train_four_ranks": (4, {"efts_cnn": ("dp+tp",), "efts_transformer": ("dp+tp", "dp+sp"),
                                       "efts_transformer_t640": ("sp4",), "hifigan_v1": ("dp+tp",)})}
MRT_B = {"efts_cnn": MRT_CNN_B, "efts_transformer": TRAIN_B, "efts_transformer_t640": TRAIN_B, "hifigan_v1": GAN_B}
MRT_T640 = 640
# the yaml's optimizer, its warmup cut to 4 steps so a first update is not lost in rounding
MRT_OPTIMIZER = {**YAML_OPTIMIZER, "scheduler_params": {"warmup_steps": 4}}


def mrt_batch(name, b):
    """The model's seeded batch of `b` rows: EFTS-CNN at T1=96, T2=512; the
    EFTS-Transformer at 4c's T1=128, T2=512 (`efts_transformer_t640`: 640);
    the GAN's V1 segments of 8192 (tones in noise) with both mels."""
    rng = np.random.default_rng(7)
    if name.startswith("efts_transformer"):
        full = train_batch(rng, 76, 80, t2=MRT_T640 if name.endswith("t640") else TRAIN_T2)
        return {k: v[:b] for k, v in full.items()}
    if name == "efts_cnn":
        tl = rng.integers(T1 // 2, T1 + 1, b).astype(np.int32)
        ml = rng.integers(T2 // 2, T2 + 1, b).astype(np.int32)
        tl[0], ml[0] = T1, T2
        text = np.zeros((b, T1), np.int32)
        for i, n in enumerate(tl):
            text[i, :n] = rng.integers(1, 76, n)
        mel = rng.standard_normal((b, T2, 80)).astype(np.float32) * (np.arange(T2)[None, :, None] < ml[:, None, None])
        return {"text": text, "text_lengths": tl, "mel": mel, "mel_lengths": ml}
    from efficient_tts_tpu_torch.dsp.mel import MelConfig, loss_mel_config, mel_spectrogram_np

    t = np.arange(8192) / 22050.0
    audio = (0.5 * np.sin(2 * np.pi * rng.uniform(100, 400, (b, 1)) * t)
             + 0.01 * rng.standard_normal((b, 8192))).astype(np.float32)
    return {"audio": audio, "mel": np.stack([mel_spectrogram_np(a, MelConfig()).T for a in audio]),
            "mel_loss": np.stack([mel_spectrogram_np(a, loss_mel_config(MelConfig(), None)).T for a in audio])}


def mrt_setup(name, dev, mesh=None, sequence_parallel=False):
    """(state, step) of `name` at its published widths from its seeded init:
    one card's without a mesh, else this rank's on `mesh`."""
    from efficient_tts_tpu_torch import compat, init
    from efficient_tts_tpu_torch.models.efficient_tts import EftsCNNConfig
    from efficient_tts_tpu_torch.models.efficient_tts_transformer import EftsTransformerConfig
    from efficient_tts_tpu_torch.models.hifigan import HiFiGANConfig
    from efficient_tts_tpu_torch.train import efts_train_step as ets
    from efficient_tts_tpu_torch.train import hifigan_train_step as hts
    from efficient_tts_tpu_torch.train.optim import HiFiGANAdam, optimizer_from_dict
    from efficient_tts_tpu_torch.train.state import create_state

    if name == "hifigan_v1":
        cfg, tx = HiFiGANConfig(), HiFiGANAdam()
        state = (hts.init_gan_state(0, cfg, tx, tx, device=dev) if mesh is None
                 else hts.shard_gan_state(0, cfg, tx, tx, mesh, device=dev))
        return state, hts.make_gan_train_step(cfg, tx, tx, device=dev, mesh=mesh)
    if name == "efts_cnn":
        cfg = EftsCNNConfig(num_symbols=76, dropout_rate=0.0, use_masking=True)
        model = compat.efts_cnn_from_jax(init.init_efts(0, cfg), cfg, device=dev, trainable=True)
    else:
        cfg = EftsTransformerConfig(num_symbols=76, dropout_rate=0.0, sigma=0.01, attn_impl="flash")
        model = compat.efts_transformer_from_jax(init.init_efts_transformer(3, cfg), cfg, device=dev, trainable=True)
    tx = optimizer_from_dict(MRT_OPTIMIZER)
    if mesh is None:
        return create_state(model, tx), ets.make_train_step(cfg, tx, device=dev)
    return (ets.shard_state(model, tx, mesh, sequence_parallel, device=dev),
            ets.make_train_step(cfg, tx, mesh=mesh, sequence_parallel=sequence_parallel, device=dev))


def mrt_params(state, mesh=None):
    """{side: ({name: parameter}, {name: first moment})} of a train state on
    the CPU, gathered into the one-card state under a mesh (collective)."""
    from efficient_tts_tpu_torch.parallel import gather_train_state
    from efficient_tts_tpu_torch.train.checkpoint import _saved

    whole = _saved(state) if mesh is None else gather_train_state(state, mesh)
    sides = {"gen": whole["gen"], "disc": whole["disc"]} if "gen" in whole else {"model": whole}

    def cpu(d):
        return {k: v.detach().float().cpu() for k, v in d.items()}

    return {side: (cpu(s["params"]), cpu(s["opt_state"]["mu"])) for side, s in sides.items()}


def mrt_flash_per_step(model, mode, mesh) -> dict:
    """K4's launches {(kernel, Tq, Tk, segmented): n} a step on a rank of
    `mesh` [data, model]: the text encoder's 4 calls at (T1, T1), the mel
    encoder's 2 and the decoder's 4 at (T2 / m padded to 64, T2) under sp,
    at (T2, T2) else; none for the other models."""
    if not model.startswith("efts_transformer"):
        return {}
    t2 = MRT_T640 if model.endswith("t640") else TRAIN_T2
    tq = t2 // mesh[1] if "sp" in mode else t2
    return {(kern, *shape, True): n for kern in ("fwd", "dkv", "dq")
            for shape, n in (((T1_TR, T1_TR), 4), ((tq + -tq % 64, t2), 6))}


def mrt_compare_tf32(got, ref, p0) -> tuple[dict, list]:
    """The EFTS-Transformer's step over ranks against one card's. Its K4
    calls take TF32 operands, and their inputs differ from one card's in the
    last bit (the linears sum in another order at another M or N), so
    a TF32 rounding may move: the bounds of 4c and 4o-iii, which hold the
    card's kernels against a plain reference (`TRAIN_TOL`, `UPDATE_TOL`)."""
    (params, mu), (r_params, r_mu) = got["model"], ref["model"]
    whole = math.sqrt(sum(float(m.double().square().sum()) for m in r_mu.values()))
    worst, fails = {"moment_rel_l2": (0.0, ""), "update_rel": (0.0, "")}, []
    for k, m in r_mu.items():
        err, own = float((mu[k] - m).double().norm()), float(m.double().norm())
        worst["moment_rel_l2"] = max(worst["moment_rel_l2"], (err / max(own, 1e-30), k))
        if err > TRAIN_TOL["leaf_rel"] * own + TRAIN_TOL["leaf_abs_of_global"] * whole:
            fails.append(("model", k, "moment", err, own))
        if own < UPDATE_TOL["leaf_above_of_global"] * whole:
            continue
        sure = m.abs() >= UPDATE_TOL["above_of_leaf_max"] * float(m.abs().max())
        d_got, d_ref = (params[k] - p0["model"][k])[sure], (r_params[k] - p0["model"][k])[sure]
        rel = float(((d_got - d_ref).abs() / d_ref.abs().clamp(min=1e-30)).max())
        worst["update_rel"] = max(worst["update_rel"], (rel, k))
        if rel > UPDATE_TOL["update_rel"]:
            fails.append(("model", k, "update", rel, UPDATE_TOL["update_rel"]))
    return {"model": worst}, fails


def mrt_compare(got, ref, p0, gan: bool) -> tuple[dict, list]:
    """The step over ranks (`got`, `mrt_params`) against one card's (`ref`)
    from the same parameters `p0`: worst errors and the failing leaves."""
    import torch

    worst, fails = {}, []
    for side, (params, mu) in got.items():
        r_params, r_mu = ref[side]
        rtol, gtol = MRT_GAN_MU[side] if gan else (MRT_TOL["mu"], MRT_TOL["mu_top"])
        top = max(float(v.abs().max()) for v in r_mu.values())
        up_top = max(float((r_params[k] - p0[side][k]).abs().max()) for k in r_mu)
        w_mu = w_up = 0.0
        for k, m in r_mu.items():
            err = float((mu[k] - m).abs().max())
            own = float(m.abs().max())
            w_mu = max(w_mu, err / max(own * rtol + gtol * top, 1e-30))
            if err > rtol * own + gtol * top:
                fails.append((side, k, "moment", err, own))
            if gan and side == "gen":
                continue  # Adam's first generator update is a sign of its noise-floor gradient
            sure = (m.abs() > 1e-3 * own) & (m.abs() > (0.0 if gan else 1e-5) * top)
            if sure.any():
                d_got, d_ref = (params[k] - p0[side][k])[sure], (r_params[k] - p0[side][k])[sure]
                ulps = 2 * float(torch.finfo(torch.float32).eps * p0[side][k].abs().max())
                bound = MRT_TOL["update"] * float((r_params[k] - p0[side][k]).abs().max()) + 1e-7 * up_top + ulps
                err = float((d_got - d_ref).abs().max())
                w_up = max(w_up, err / bound)
                if err > bound:
                    fails.append((side, k, "update", err, bound))
        worst[side] = {"moment_of_bound": w_mu, "update_of_bound": w_up}
    return worst, fails


def mrt_digest(got) -> str:
    import hashlib

    h = hashlib.sha256()
    for side in sorted(got):
        for k in sorted(got[side][0]):
            h.update(got[side][0][k].numpy().tobytes())
    return h.hexdigest()


def train_rank_main(opts) -> int:
    """One rank of 4r: `train_one_rank` (a world of one under NCCL),
    `train_two_ranks` / `train_four_ranks` (gloo, every rank on card 0) or `train_clis` (the two
    training CLIs over two ranks). Writes `<out>/<task>.rank<r>.json`; a
    failed check raises."""
    import torch
    import torch.distributed as dist

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from efficient_tts_tpu_torch import _build
    from efficient_tts_tpu_torch.ops import flash_attention as fa
    from efficient_tts_tpu_torch.ops import mrf
    from efficient_tts_tpu_torch.parallel import initialize_multihost, make_mesh, rank_device, split_batch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if opts.rank_task == "train_one_rank":
        # a step on (1, 1) is held to one card's bit for bit: no convolution
        # algorithm that sums in a run-dependent order
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    for name in ("mrf_stage", "flash_attention"):
        if not _build._target(_build.SRC_DIR / f"{name}.cu").exists():
            raise AssertionError(f"csrc/{name}.cu is not built: run the ranks from chip_smoke.py's phase 4r")
    dev = rank_device("cuda", index=0)
    torch.cuda.set_device(dev)
    lines = []

    if opts.rank_task == "train_clis":
        from efficient_tts_tpu_torch.bin import train, train_vocoder

        with open(os.path.join(opts.out, "clis.json")) as f:
            paths = json.load(f)
        dist_args = ["--coordinator", opts.init, "--num_processes", str(opts.world), "--process_id", str(opts.rank),
                     "--dist_backend", "gloo", "--device_index", "0"]
        t0 = time.perf_counter()
        t = train.main(["--config", paths["cnn"], "--train_fid_scp", paths["train"], "--dev_fid_scp", paths["dev"],
                        "--outdir", paths["train_out"], *dist_args])
        rank = dist.get_rank()
        lines.append({"what": "bin.train", "rank": rank, "world": opts.world, "backend": dist.get_backend(),
                      "mesh": [t.mesh.shape["data"], t.mesh.shape["model"]], "step": t.state["step"],
                      "losses": [e["loss"] for e in t.metrics_log], "evals": len(t.eval_log),
                      "param_sum": float(sum(float(p.double().sum()) for p in t.state["params"].parameters())),
                      "seconds": time.perf_counter() - t0})
        mrf.reset_launches()
        t0 = time.perf_counter()
        v = train_vocoder.main(["--wav_scp", paths["wav_scp"], "--dev_wav_scp", paths["wav_scp"], "--outdir",
                                paths["voc_out"], "--batch_size", "4", "--train_max_steps", "2",
                                "--save_interval_steps", "2", "--eval_interval_steps", "2", "--log_interval_steps", "1",
                                *dist_args])
        torch.cuda.synchronize()
        lines.append({"what": "bin.train_vocoder", "rank": rank, "world": opts.world, "backend": dist.get_backend(),
                      "data_path": v.data_path, "step": v.state["step"],
                      "g_losses": [e["g_loss"] for e in v.metrics_log],
                      "evals": len(v.eval_log), "mrf_launches": launch_list(dict(mrf.launches)), "dtype": "f32",
                      "param_sum": float(sum(float(p.double().sum()) for s in ("gen", "disc")
                                             for p in v.state[s]["params"].parameters())),
                      "seconds": time.perf_counter() - t0})
    else:
        initialize_multihost(opts.init, opts.world, opts.rank, backend=opts.backend, device="cuda")
        rank = dist.get_rank()

        def report(**line):
            lines.append({"rank": rank, "world": opts.world, "backend": dist.get_backend(), **line})

        failed = []  # every mode runs and reports; the task fails at its end
        if opts.rank_task == "train_one_rank":
            # every mode on a (1, 1) mesh, bit-equal to one card, at small batches
            mesh = make_mesh(1, 1)
            for name, b in (("efts_cnn", 16), ("efts_transformer", 8), ("hifigan_v1", 2)):
                batch = mrt_batch(name, b)
                state, step = mrt_setup(name, dev)
                state, m_ref = step(state, batch)
                ref = mrt_params(state)
                del state, step
                for mode in MRT_MODES[name]:
                    fa.reset_launches()
                    state, step = mrt_setup(name, dev, mesh, "sp" in mode)
                    state, m = step(state, batch)
                    got = mrt_params(state, mesh)
                    equal = (all(float(m[k]) == float(m_ref[k]) for k in m_ref)
                             and all(torch.equal(got[s][i][k], ref[s][i][k]) for s in ref for i in (0, 1)
                                     for k in ref[s][i]))
                    report(what="train_step(mesh=)", model=name, mode=mode, mesh=[1, 1], B=b, bit_equal=equal,
                           flash_launches=[[*k, n] for k, n in fa.launches.items()])
                    if not equal:
                        failed.append(f"{name} {mode} on (1, 1) differs from one card's step")
                    del state, step
                torch.cuda.empty_cache()
        elif opts.rank_task in MRT_WORLDS:
            modes = MRT_WORLDS[opts.rank_task][1]
            meshes = {MRT_MESHES[m]: make_mesh(*MRT_MESHES[m]) for m in sorted({m for v in modes.values() for m in v})}
            for name in modes:
                b = MRT_B[name]
                batch = mrt_batch(name, b)
                ref = p0 = None
                if rank == 0:  # one card's step, on rank 0 alone, before the meshes'
                    state, step = mrt_setup(name, dev)
                    p0 = {s: ps for s, (ps, _) in mrt_params(state).items()}
                    torch.cuda.reset_peak_memory_stats(dev)
                    state, m_ref = step(state, batch)
                    torch.cuda.synchronize()
                    ref, m_ref = mrt_params(state), {k: float(v) for k, v in m_ref.items()}
                    one_peak = torch.cuda.max_memory_allocated(dev) / 2**20
                    del state, step
                    torch.cuda.empty_cache()
                dist.barrier()
                for mode in modes[name]:
                    mesh = meshes[MRT_MESHES[mode]]
                    state, step = mrt_setup(name, dev, mesh, "sp" in mode)
                    blk = {k: split_batch(v, mesh) for k, v in batch.items()}
                    fa.reset_launches()
                    torch.cuda.reset_peak_memory_stats(dev)
                    t0 = time.perf_counter()
                    state, m = step(state, blk)
                    torch.cuda.synchronize()
                    secs = time.perf_counter() - t0
                    peak = torch.cuda.max_memory_allocated(dev) / 2**20
                    flash = dict(fa.launches)
                    got = mrt_params(state, mesh)
                    metrics = {k: float(v) for k, v in m.items()}
                    line = dict(what="train_step(mesh=)", model=name, mode=mode, mesh=list(MRT_MESHES[mode]), B=b,
                                metrics=metrics, step_s=secs, peak_mb=peak, params_sha256=mrt_digest(got),
                                flash_launches=[[*k, n] for k, n in flash.items()])
                    if rank == 0:
                        tf32 = name.startswith("efts_transformer")
                        worst, fails = (mrt_compare_tf32(got, ref, p0) if tf32
                                        else mrt_compare(got, ref, p0, gan=name == "hifigan_v1"))
                        rel = {k: abs(metrics[k] - m_ref[k]) / max(abs(m_ref[k]), 1e-30) for k in m_ref}
                        tol = ({"metric_rel": MRT_TOL["metric_rel"], **TRAIN_TOL, **UPDATE_TOL}
                               if tf32 else
                               {**MRT_TOL, **({"gan_mu": MRT_GAN_MU} if name == "hifigan_v1" else {})})
                        line.update(metric_rel_err=rel, worst=worst, failing=fails[:5], one_card_peak_mb=one_peak,
                                    tolerance=tol)
                        if fails or max(rel.values()) > MRT_TOL["metric_rel"]:
                            failed.append(f"{name} {mode} over {opts.world} ranks disagrees with one card: {line}")
                    report(**line)
                    del state, step, got
                    torch.cuda.empty_cache()
        else:
            raise ValueError(f"unknown rank task {opts.rank_task!r}")
        if failed:
            print(json.dumps(lines), flush=True)
            raise AssertionError("\n".join(failed))
    with open(os.path.join(opts.out, f"{opts.rank_task}.rank{rank}.json"), "w") as f:
        json.dump(lines, f)
    dist.destroy_process_group()
    return 0


def multi_rank_training_phase(torch, new_launches, work):
    """4r: training over ranks on the one card. i. a world of one under NCCL
    and ii. two and four ranks under gloo run at once, each in its own processes;
    then iii. bin.train and bin.train_vocoder over two ranks under gloo, and
    rank 0's checkpoints resumed on one card. Returns the ranks' flash
    launches {path: {(kernel, Tq, Tk, segmented): n}}."""
    from efficient_tts_tpu_torch.bench.corpus import make_corpus
    from efficient_tts_tpu_torch.bin import train, train_vocoder
    from efficient_tts_tpu_torch.utils.config import load_config

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    runs = [("train_one_rank", start_ranks("train_one_rank", 1, work, "nccl")),
            *((task, start_ranks(task, world, work, "gloo")) for task, (world, _) in MRT_WORLDS.items())]
    try:
        for _, (procs, logs) in runs:
            wait_ranks(procs, logs, timeout=600)
    finally:
        for _, (procs, _) in runs:
            for p in procs:
                p.kill()
    flash, digests = {}, {}
    # K4 a step on every rank of the transformer (`mrt_flash_per_step`)
    for task, (procs, _) in runs:
        for r in range(len(procs)):
            with open(os.path.join(work, f"{task}.rank{r}.json")) as f:
                for line in json.load(f):
                    log({"phase": "multi_rank_training", **line})
                    got = {tuple(k): n for *k, n in line["flash_launches"]}
                    want = mrt_flash_per_step(line["model"], line["mode"], line["mesh"])
                    if got != want:
                        raise AssertionError(f"{line['model']} {line['mode']} on rank {r} of {line['world']}: flash "
                                             f"launches {got}, expected {want}")
                    if line["world"] > 1:
                        tag = f"multi_rank_training_{line['backend']}{line['world']}_{line['model']}_{line['mode']}"
                        flash[f"{tag}_rank{r}"] = {tuple(k): n for *k, n in line["flash_launches"]}
                        digests.setdefault(tag, set()).add(line["params_sha256"])
    if any(len(d) != 1 for d in digests.values()):
        raise AssertionError(f"the ranks' gathered states differ: {digests}")
    t_iii = time.perf_counter()

    # iii. the two CLIs over two ranks on a synthetic corpus, the EFTS-CNN at
    # the char yaml's widths (batch 8) and HiFi-GAN V1 (batch 4)
    corpus = make_corpus(os.path.join(work, "corpus"), n_train=16, n_dev=4, seed=3, min_s=1.0, max_s=2.0)
    config = load_config(os.path.join(os.path.dirname(os.path.abspath(__file__)), "efficient_tts_tpu_torch",
                                      "configs", "lj_efts_cnn_char.yaml"))
    config.update(batch_size=8, train_max_steps=2, save_interval_steps=2, eval_interval_steps=2,
                  log_interval_steps=1)
    config["dataset_params"]["wav_path"] = corpus["wavs"]
    paths = {"cnn": os.path.join(work, "cnn.json"), "train": corpus["train"], "dev": corpus["dev"],
             "wav_scp": os.path.join(work, "wav.scp"), "train_out": os.path.join(work, "cli_train"),
             "voc_out": os.path.join(work, "cli_voc")}
    with open(paths["cnn"], "w") as f:
        json.dump(config, f)
    with open(corpus["train"]) as f, open(paths["wav_scp"], "w") as g:
        g.writelines(os.path.join(work, "corpus", line.split("|")[0]) + "\n" for line in f)
    with open(os.path.join(work, "clis.json"), "w") as f:
        json.dump(paths, f)
    procs, logs = start_ranks("train_clis", 2, work, "gloo")
    try:
        wait_ranks(procs, logs, timeout=600)
    finally:
        for p in procs:
            p.kill()
    cli = [json.load(open(os.path.join(work, f"train_clis.rank{r}.json"))) for r in range(2)]
    for r, lines in enumerate(cli):
        for line in lines:
            log({"phase": "multi_rank_training", **line})
    (t0, v0), (t1, v1) = cli
    written = sorted(os.listdir(paths["train_out"])), sorted(os.listdir(paths["voc_out"]))
    if (t0["param_sum"] != t1["param_sum"] or v0["param_sum"] != v1["param_sum"] or t0["losses"] != t1["losses"]
            or v0["data_path"] != "host" or v0["evals"] != 1 or v1["evals"] != 0
            or not all(math.isfinite(x) for x in t0["losses"] + v0["g_losses"])):
        raise AssertionError(f"the CLIs over two ranks: {cli}")
    new_launches["train_vocoder_two_ranks_eval", "f32"] = {(d, c): n for d, c, n in v0["mrf_launches"]}
    # rank 0's checkpoints, one-card files, resumed on this card for one more step
    resumed = train.main(["--config", paths["cnn"], "--train_fid_scp", paths["train"], "--outdir",
                          os.path.join(work, "resumed_train"), "--resume",
                          os.path.join(paths["train_out"], "checkpoint-2steps"), "--set", "train_max_steps=3"])
    voc = train_vocoder.main(["--wav_scp", paths["wav_scp"], "--outdir", os.path.join(work, "resumed_voc"),
                              "--resume", os.path.join(paths["voc_out"], "checkpoint-2steps"), "--batch_size", "4",
                              "--train_max_steps", "3", "--device_corpus", "off"])
    steps = [resumed.state["step"], voc.state["step"]]
    losses = [resumed.metrics_log[-1]["loss"], voc.metrics_log[-1]["g_loss"]]
    log({"phase": "multi_rank_training", "what": "rank 0's checkpoints resumed on one card", "files": written,
         "steps": steps, "losses": losses, "seconds": time.perf_counter() - t_iii})
    if steps != [3, 3] or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"resuming rank 0's checkpoints on one card: steps {steps}, losses {losses}")
    del resumed, voc
    log({"phase": "multi_rank_training", "what": "phase 4r", "seconds": time.perf_counter() - t_phase})
    return flash


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", help="a directory holding an earlier tree's flash_attention.cu, "
                    "mrf_stage_int8.cu and probe_matmul.cu with their headers, timed in turns with this "
                    "tree's (phase 5b)")
    # phases 4q and 4r run their ranks as processes of this script
    for flag in ("--rank_task", "--init", "--out", "--backend"):
        ap.add_argument(flag, help=argparse.SUPPRESS)
    for flag in ("--rank", "--world"):
        ap.add_argument(flag, type=int, help=argparse.SUPPRESS)
    opts = ap.parse_args(argv)
    if opts.rank_task:
        return (train_rank_main if opts.rank_task.startswith("train_") else rank_main)(opts)

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import dataclasses

    import torch.nn.functional as F

    from efficient_tts_tpu_torch import _build, compat, init, pipeline
    from efficient_tts_tpu_torch import bench
    from efficient_tts_tpu_torch.bench import card_line, time_ms
    from efficient_tts_tpu_torch.bench import mrf_fused as bench_mrf
    from efficient_tts_tpu_torch.bench import probe_int8 as bench_probe
    from efficient_tts_tpu_torch.models.efficient_tts import EftsCNNConfig
    from efficient_tts_tpu_torch.models.efficient_tts_transformer import EftsTransformerConfig
    from efficient_tts_tpu_torch.models.hifigan import HiFiGANConfig
    from efficient_tts_tpu_torch.ops import flash_attention as fa
    from efficient_tts_tpu_torch.ops import mrf, mrf_int8
    from efficient_tts_tpu_torch.ops import probe_matmul as pm
    from efficient_tts_tpu_torch.utils import flops as flop_counts

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")

    # 1. device
    card = card_line()
    CARD["card"] = card
    log({"phase": "device", "card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
         "pyyaml": yaml_available()})

    # 2. build
    t0 = time.perf_counter()
    built = _build.build(verbose=True)
    for name, info in built.items():
        print(f"--- nvcc {name} ---\n{info['log']}", file=sys.stderr)
    log({"phase": "build", "seconds": time.perf_counter() - t0, "sources": sorted(built)})
    sass = op_counts(read_sass(built["mrf_stage"]["path"]))
    log({"phase": "build", "what": "mrf_stage SASS", **sass})
    if sass["HGMMA"] == 0 or sass["UTMALDG"] == 0 or sass["HMMA"] != 0:
        raise AssertionError(f"the MRF library is not wgmma fed by TMA: {sass}")
    # the flash library function by function: every kernel is wgmma (HGMMA)
    # with no mma.sync (HMMA) left, the forward's tiles by TMA (UTMALDG)
    flash_sass = sass_by_function(built["flash_attention"]["path"])
    for part in ("fwd", "dkv", "dq"):
        fns = {name: c for name, c in flash_sass.items() if FLASH_KERNELS[part] in name}
        log({"phase": "build", "what": f"flash_attention SASS, {FLASH_KERNELS[part]}", "functions": len(fns),
             **{op: [c[op] for c in fns.values()] for op in SASS_OPS}})
        if (len(fns) != FLASH_FUNCTIONS[part] or any(c["HGMMA"] == 0 or c["HMMA"] != 0 for c in fns.values())
                or (part == "fwd" and any(c["UTMALDG"] == 0 for c in fns.values()))):
            raise AssertionError(f"the flash {part} kernels are not {FLASH_FUNCTIONS[part]} wgmma functions "
                                 f"free of mma.sync: {fns}")
    # the W8A8 conv kernels: integer wgmma (IGMMA) fed by TMA, no IMMA
    int8_sass = {name: c for name, c in sass_by_function(built["mrf_stage_int8"]["path"]).items()
                 if INT8_KERNEL in name}
    log({"phase": "build", "what": f"mrf_stage_int8 SASS, {INT8_KERNEL}", "functions": len(int8_sass),
         **{op: [c[op] for c in int8_sass.values()] for op in SASS_OPS}})
    if len(int8_sass) != INT8_FUNCTIONS or any(c["IGMMA"] == 0 or c["UTMALDG"] == 0 or c["IMMA"] != 0
                                               for c in int8_sass.values()):
        raise AssertionError(f"the W8A8 kernels are not {INT8_FUNCTIONS} s8-wgmma functions fed by TMA: {int8_sass}")
    # the probe's two kernels: wgmma (bf16 HGMMA, int8 IGMMA) fed by TMA, no mma.sync
    probe_sass = {name: c for name, c in sass_by_function(built["probe_matmul"]["path"]).items()
                  if PROBE_KERNEL in name}
    log({"phase": "build", "what": f"probe_matmul SASS, {PROBE_KERNEL}", "functions": len(probe_sass),
         **{op: [c[op] for c in probe_sass.values()] for op in SASS_OPS}})
    if (len(probe_sass) != 2 or any(c["UTMALDG"] == 0 or c["HMMA"] != 0 or c["IMMA"] != 0 for c in probe_sass.values())
            or sorted((c["HGMMA"] > 0, c["IGMMA"] > 0) for c in probe_sass.values()) != [(False, True), (True, False)]):
        raise AssertionError(f"the probe is not a bf16 and an int8 wgmma function fed by TMA: {probe_sass}")

    voc_cfg = HiFiGANConfig()
    efts_cfg = EftsCNNConfig(num_symbols=76, dropout_rate=0.0, use_masking=True)
    ks, ds = voc_cfg.resblock_kernel_sizes, voc_cfg.resblock_dilation_sizes
    stages = []
    t = T2
    for i, u in enumerate(voc_cfg.upsample_rates):
        t *= u
        stages.append((voc_cfg.upsample_initial_channel // 2 ** (i + 1), t))

    # 3. kernel vs plain version at the main-path shapes
    kernel_rows = {}
    for c, t in stages:
        x, ws, bs, order = stage_inputs(torch, c, t, seed=c, dev=dev, kernel_sizes=ks, dilation_sizes=ds)
        out = mrf.mrf_stage(x, mrf.kernel_weights(ws), bs, ks, ds)
        torch.cuda.synchronize()
        stats = err_stats(out, mrf.mrf_stage_reference(x, ws, bs, ks, ds))
        log({"phase": "kernel_vs_plain", "channels": c, "shape": [B, t, c], **stats, "tolerance": STAGE_TOL})
        if not within(stats, STAGE_TOL):
            raise AssertionError(f"MRF kernel disagrees with its plain version at C={c}: {stats}")
        kernel_rows[c] = {"max_abs_err": stats["max_abs_err"], "rel_rms": stats["rel_rms"]}
        del x, ws, bs, out
    # the flash forward: the decoder's shape (no segment ids), the text
    # encoder's, and both at the training batch (masked)
    flash_rows = {}
    for name, fb, t, segmented in FLASH_FWD_SHAPES:
        q, k, v, seg = flash_inputs(torch, t, seed=t, dev=dev, segmented=segmented, b=fb)
        out = fa.flash_attention(q, k, v, seg, sm_scale=96**-0.5)
        torch.cuda.synchronize()
        stats = err_stats(out, fa.flash_attention_reference(q, k, v, seg, sm_scale=96**-0.5))
        log({"phase": "kernel_vs_plain", "kernel": "flash_attention", "shape": list(q.shape),
             "segment_ids": segmented, **stats, "tolerance": FLASH_TOL})
        if not within(stats, FLASH_TOL):
            raise AssertionError(f"flash kernel disagrees with its plain version at {tuple(q.shape)}: {stats}")
        flash_rows[name] = {"max_abs_err": stats["max_abs_err"], "rel_rms": stats["rel_rms"]}
        del q, k, v, seg, out
    # the backward kernels at the training shapes: the T2 calls' length without
    # and with segment ids (training masks every call), the text encoder's
    # with ragged ones
    bwd_shapes = ((TRAIN_T2, False), (TRAIN_T2, True), (T1_TR, True))
    bwd_rows = {}
    for t, segmented in bwd_shapes:
        check_flash_backward(torch, fa, t, segmented, dev, bwd_rows)
    # 3b. the forward, dkv and dq at a sequence-parallel rank's rows against
    # the whole sequence's keys (the transformer's mel side over m ranks, 4r)
    for tq, tk in SP_FLASH_SHAPES:
        flash_rows[f"sp_t{tq}_{tk}"] = check_flash_backward(torch, fa, tq, True, dev, bwd_rows, tk=tk)
    # the f32 MRF kernel (K3's f32 mode) at the V1 stage shapes
    f32_rows = {}
    for c, t in stages:
        x, ws, bs, order = stage_inputs(torch, c, t, seed=c, dev=dev, kernel_sizes=ks, dilation_sizes=ds,
                                        dtype=torch.float32)
        out = mrf.mrf_stage(x, mrf.kernel_weights(ws), bs, ks, ds)
        torch.cuda.synchronize()
        stats = err_stats(out, mrf.mrf_stage_reference(x, ws, bs, ks, ds))
        log({"phase": "kernel_vs_plain", "kernel": "mrf_stage_f32", "channels": c, "shape": [B, t, c], **stats,
             "tolerance": F32_STAGE_TOL})
        if not within(stats, F32_STAGE_TOL):
            raise AssertionError(f"f32 MRF kernel disagrees with its plain version at C={c}: {stats}")
        f32_rows[c] = {"max_abs_err": stats["max_abs_err"], "rel_rms": stats["rel_rms"]}
        del x, ws, bs, out
    # the W8A8 MRF kernel (K2), bit for bit, on the bench's weights and input
    for c, t in INT8_SHAPES:
        st = bench_mrf.make_stage(B, t * c // bench_mrf.LANES, c, dev)
        for act in (None, st["act_scales"]):
            args = (st["x"], st["wq"], st["scales"], st["biases"], ks, ds, act)
            out = mrf_int8.mrf_stage_int8(*args)
            torch.cuda.synchronize()
            stats = err_stats(out, mrf_int8.mrf_stage_int8_reference(*args))
            log({"phase": "kernel_vs_plain", "kernel": "mrf_stage_int8", "scales": "dynamic" if act is None
                 else "static", "shape": [B, t, c], **stats, "tolerance": "bit-equal"})
            if stats["max_abs_err"] != 0.0:
                raise AssertionError(f"W8A8 MRF kernel differs from its plain version at {[B, t, c]}: {stats}")
        del st, args, out
    # the matmul probe (K5) at the bench's shape, then at row counts that end
    # in a partial 64-row tile (the bench's inputs, cut or extended)
    probe_rows = {}
    for m in (bench_probe.M, *PROBE_PARTIAL_M):
        for name, (x, w) in bench_probe.make_inputs(m, dev).items():
            out = pm.probe_matmul(x, w)
            torch.cuda.synchronize()
            stats = err_stats(out, pm.probe_matmul_reference(x, w))
            tol = PROBE_BF16_TOL if name == "bf16" else "bit-equal"
            log({"phase": "kernel_vs_plain", "kernel": f"probe_matmul_{name}", "shape": list(x.shape), **stats,
                 "tolerance": tol})
            if stats["rel_rms"] > PROBE_BF16_TOL["rel_rms"] or (name == "int8" and stats["max_abs_err"] != 0.0):
                raise AssertionError(f"the {name} probe kernel disagrees with its plain version at M={m}: {stats}")
            if m == bench_probe.M:
                probe_rows[name] = {"max_abs_err": stats["max_abs_err"], "rel_rms": stats["rel_rms"]}
            del x, w, out

    # 4a. EFTS-CNN main path at full width
    efts = compat.efts_cnn_from_jax(init.init_efts(0, efts_cfg), efts_cfg, device="cuda")
    voc = compat.hifigan_generator_from_jax(init.init_generator(1, voc_cfg), voc_cfg, device="cuda")
    batches = ragged_batches(np.random.default_rng(0), T1, efts_cfg.num_symbols)
    hop = voc_cfg.hop_size
    bf16 = torch.bfloat16

    mrf.reset_launches()
    fa.reset_launches()
    results = [pipeline.synthesize(efts, voc, text, lengths, compute_dtype=bf16) for text, lengths in batches]
    wav_fixed, wl_fixed, mel_fixed = pipeline.synthesize_fixed(
        efts, voc, batches[0][0], batches[0][1], T2, compute_dtype=bf16)
    torch.cuda.synchronize()
    launches = dict(mrf.launches)
    n_synth = len(batches) + 1
    expected = {("bf16", c): 18 * n_synth for c, _ in stages}
    log({"phase": "main_path", "model": "efts_cnn", "syntheses": n_synth, "mrf_launches": keyed(launches),
         "expected": keyed(expected), "flash_launches": sum(fa.launches.values())})
    if launches != expected:
        raise AssertionError(f"MRF launches {launches}, expected {expected}")

    check_synthesize(pipeline, efts, batches, results, hop, 64)
    check_fixed(torch, wav_fixed, mel_fixed, T2, hop, efts_cfg.odim)
    wav_plain, wl_plain, _ = pipeline.synthesize_fixed(
        efts, voc, batches[0][0], batches[0][1], T2, compute_dtype=bf16, mrf_impl="plain")
    stats = err_stats(wav_fixed, wav_plain)
    log({"phase": "main_path_vs_plain_mrf", "t2": T2, "wav_lengths": wl_fixed.tolist(), **stats,
         "tolerance": WAV_TOL, "buckets": [int(w.shape[1] // hop) for w, _ in results]})
    if not torch.equal(wl_fixed, wl_plain) or not within(stats, WAV_TOL):
        raise AssertionError(f"synthesize_fixed with the MRF kernel disagrees with the plain path: {stats}")
    del wav_fixed, wav_plain, mel_fixed, results

    # 4b. EFTS-Transformer main path at full width (lj_efts_transformer_phnseq.yaml)
    tr_cfg = EftsTransformerConfig(num_symbols=76, dropout_rate=0.0, sigma=0.01, attn_impl="flash")
    tr_params = init.init_efts_transformer(2, tr_cfg)
    # random weights give durations near exp(0) - 1 = 0; this bias gives about
    # 4.5 frames per token (the bench shape T1=96, T2=512 has 5.3), so the
    # ragged T1=128 batches land in 640-frame buckets
    tr_params["duration_predictor"]["out"]["b"][:] = 1.3
    tr = compat.efts_transformer_from_jax(tr_params, tr_cfg, device="cuda")
    tr_plain = compat.efts_transformer_from_jax(
        tr_params, dataclasses.replace(tr_cfg, attn_impl="flash_plain"), device="cuda")
    tr_batches = ragged_batches(np.random.default_rng(1), T1_TR, tr_cfg.num_symbols)

    mrf.reset_launches()
    fa.reset_launches()
    tr_results = [pipeline.synthesize(tr, voc, text, lengths, bucket_multiple=128, compute_dtype=bf16)
                  for text, lengths in tr_batches]
    wav_fixed, wl_fixed, mel_fixed = pipeline.synthesize_fixed(
        tr, voc, tr_batches[0][0], tr_batches[0][1], T2, compute_dtype=bf16)
    torch.cuda.synchronize()
    tr_launches, tr_flash = dict(mrf.launches), flash_by_segments(fa.launches)
    if any(kernel != "fwd" for kernel, *_ in fa.launches):
        raise AssertionError(f"synthesis launched a backward kernel: {fa.launches}")
    n_tr = len(tr_batches) + 1
    expected = {("bf16", c): 18 * n_tr for c, _ in stages}
    # per synthesis: 4 text-encoder layers (segment ids) and 4 decoder layers (none)
    expected_flash = {True: tr_cfg.n_text_encoder_layer * n_tr, False: tr_cfg.n_decoder_layer * n_tr}
    log({"phase": "main_path", "model": "efts_transformer", "syntheses": n_tr, "mrf_launches": keyed(tr_launches),
         "expected": keyed(expected), "flash_launches": {str(k): n for k, n in tr_flash.items()},
         "flash_expected": {str(k): n for k, n in expected_flash.items()}})
    if tr_launches != expected or tr_flash != expected_flash:
        raise AssertionError(f"transformer path launches MRF {tr_launches}, flash {tr_flash}; "
                             f"expected {expected}, {expected_flash}")

    check_synthesize(pipeline, tr, tr_batches, tr_results, hop, 128)
    check_fixed(torch, wav_fixed, mel_fixed, T2, hop, tr_cfg.odim)
    wav_plain, wl_plain, mel_plain = pipeline.synthesize_fixed(
        tr_plain, voc, tr_batches[0][0], tr_batches[0][1], T2, compute_dtype=bf16)
    # a TF32 difference in e can move round(e) by one frame; compare where both are valid
    both = torch.minimum(wl_fixed, wl_plain)
    valid = torch.arange(T2 * hop, device=dev)[None, :] < both[:, None]
    stats = err_stats(wav_fixed * valid, wav_plain * valid)
    mel_valid = valid[:, ::hop, None]
    mel_stats = err_stats(mel_fixed * mel_valid, mel_plain * mel_valid)
    log({"phase": "main_path_vs_plain_attention", "t2": T2, "wav_lengths": wl_fixed.tolist(),
         "wav_lengths_plain": wl_plain.tolist(), **stats, "mel": mel_stats, "tolerance": TR_WAV_TOL,
         "buckets": [int(w.shape[1] // hop) for w, _ in tr_results]})
    if (not within(stats, TR_WAV_TOL) or not within(mel_stats, TR_WAV_TOL)
            or int((wl_fixed - wl_plain).abs().max()) > hop):
        raise AssertionError(f"synthesize_fixed with the flash kernel disagrees with the plain path: {stats}")
    del wav_fixed, wav_plain, mel_fixed, mel_plain, tr_results

    # 4e. f32 synthesis (compute_dtype=None, every other argument at its
    # default) for both models, through the f32 MRF kernel
    f32_launches = {}
    for name, model, model_batches in (("efts_cnn", efts, batches), ("efts_transformer", tr, tr_batches)):
        mrf.reset_launches()
        f32_results = [pipeline.synthesize(model, voc, text, lengths) for text, lengths in model_batches]
        wav_fixed, wl_fixed, mel_fixed = pipeline.synthesize_fixed(model, voc, *model_batches[0], T2)
        torch.cuda.synchronize()
        f32_launches[name] = dict(mrf.launches)
        n_f32 = len(model_batches) + 1
        expected = {("f32", c): 18 * n_f32 for c, _ in stages}
        log({"phase": "main_path", "model": name, "dtype": "f32", "syntheses": n_f32,
             "mrf_launches": keyed(f32_launches[name]), "expected": keyed(expected),
             "buckets": [int(w.shape[1] // hop) for w, _ in f32_results]})
        if f32_launches[name] != expected:
            raise AssertionError(f"f32 synthesis launched MRF {f32_launches[name]}, expected {expected}")
        check_synthesize(pipeline, model, model_batches, f32_results, hop, 64)
        check_fixed(torch, wav_fixed, mel_fixed, T2, hop, model.cfg.odim)
        wav_plain, wl_plain, _ = pipeline.synthesize_fixed(model, voc, *model_batches[0], T2, mrf_impl="plain")
        stats = err_stats(wav_fixed, wav_plain)
        log({"phase": "main_path_vs_plain_mrf", "model": name, "dtype": "f32", "t2": T2, **stats,
             "tolerance": F32_WAV_TOL})
        if (not torch.equal(wl_fixed, wl_plain) or stats["max_abs_err"] > F32_WAV_TOL["max_abs"]
                or stats["rel_rms"] > F32_WAV_TOL["rel_rms"]):
            raise AssertionError(f"f32 synthesize_fixed with the MRF kernel disagrees with the plain path: {stats}")
        del f32_results, wav_fixed, wav_plain, mel_fixed

    # 4c. EFTS-Transformer training at the yaml's widths, dropout off: the kernel
    # path against the same model with the plain attention
    from efficient_tts_tpu_torch.train.efts_train_step import batch_to_device, make_train_step
    from efficient_tts_tpu_torch.train.optim import optimizer_from_dict
    from efficient_tts_tpu_torch.train.state import create_state, named_params
    from efficient_tts_tpu_torch.utils.precision import full_f32

    train_cfg = EftsTransformerConfig(num_symbols=76, dropout_rate=0.0, sigma=0.01, attn_impl="flash")
    plain_cfg = dataclasses.replace(train_cfg, attn_impl="flash_plain")
    train_params = init.init_efts_transformer(3, train_cfg)
    batch = batch_to_device(train_batch(np.random.default_rng(2), train_cfg.num_symbols, train_cfg.odim), dev)

    def trainable(cfg):
        return compat.efts_transformer_from_jax(train_params, cfg, device="cuda", trainable=True)

    def first_grads(model):
        with full_f32():
            out = model(batch["text"], batch["text_lengths"], batch["mel"], batch["mel_lengths"])
            params = named_params(model)
            grads = torch.autograd.grad(out["loss"], list(params.values()))
        return dict(zip(params, grads)), float(out["loss"].detach())

    def run_steps(model, cfg, n, gen=None):
        """n steps of `make_train_step` from a fresh optimizer state; the
        metrics of each step and the launch counts after each."""
        tx = optimizer_from_dict(YAML_OPTIMIZER)
        state = create_state(model, tx)
        step = make_train_step(cfg, tx)
        metrics, counts = [], []
        for _ in range(n):
            state, m = step(state, batch, gen)
            metrics.append(m)
            counts.append(dict(fa.launches))
        torch.cuda.synchronize()
        metrics = [{k: float(v) for k, v in m.items()} for m in metrics]
        if not all(math.isfinite(v) for m in metrics for v in m.values()):
            raise AssertionError(f"training gave non-finite metrics: {metrics}")
        return state, step, metrics, counts

    model_k, model_p = trainable(train_cfg), trainable(plain_cfg)
    (g_k, loss_k), (g_p, loss_p) = first_grads(model_k), first_grads(model_p)
    g_norm = math.sqrt(sum(float(g.square().sum()) for g in g_p.values()))
    leaf_fail, leaf_worst = [], (0.0, "")
    for name, gp in g_p.items():
        err, ref = float((g_k[name] - gp).norm()), float(gp.norm())
        if err > TRAIN_TOL["leaf_rel"] * ref + TRAIN_TOL["leaf_abs_of_global"] * g_norm:
            leaf_fail.append((name, err, ref))
        if ref > 1e-3 * g_norm:
            leaf_worst = max(leaf_worst, (err / ref, name))
    log({"phase": "train_first_step_gradients", "leaves": len(g_p), "loss": loss_k, "loss_plain": loss_p,
         "grad_norm": g_norm, "worst_leaf_rel_err": leaf_worst[0], "worst_leaf": leaf_worst[1],
         "failing_leaves": leaf_fail[:5], "tolerance": TRAIN_TOL})
    if leaf_fail or abs(loss_k - loss_p) > TRAIN_TOL["loss_rel"] * abs(loss_p):
        raise AssertionError(f"first-step gradients through the kernels disagree with the plain path: {leaf_fail[:5]}")
    del g_k, g_p

    mrf.reset_launches()
    fa.reset_launches()
    state_k, step_k, metrics_k, counts = run_steps(model_k, train_cfg, N_TRAIN_STEPS)
    train_launches = dict(fa.launches)
    n_t1, n_t2 = train_cfg.n_text_encoder_layer, train_cfg.n_mel_encoder_layer + train_cfg.n_decoder_layer
    per_step = {(kern, t, t, True): n for kern in ("fwd", "dkv", "dq") for t, n in ((T1_TR, n_t1), (TRAIN_T2, n_t2))}
    log({"phase": "main_path", "model": "efts_transformer_training", "steps": N_TRAIN_STEPS,
         "flash_launches": {"/".join(map(str, k)): n for k, n in train_launches.items()},
         "expected_per_step": {"/".join(map(str, k)): n for k, n in per_step.items()},
         "mrf_launches": dict(mrf.launches), "metrics": metrics_k})
    for i, c in enumerate(counts):
        if c != {k: n * (i + 1) for k, n in per_step.items()}:
            raise AssertionError(f"after training step {i + 1} the flash launches are {c}, expected "
                                 f"{per_step} per step")
    if mrf.launches:
        raise AssertionError(f"training launched the MRF kernel: {mrf.launches}")

    fa.reset_launches()
    state_p, step_p, metrics_p, _ = run_steps(model_p, plain_cfg, N_TRAIN_STEPS)
    if fa.launches:
        raise AssertionError(f"the plain attention path launched {fa.launches}")
    diffs = [{"loss_rel": abs(a["loss"] - b["loss"]) / abs(b["loss"]),
              "grad_norm_rel": abs(a["grad_norm"] - b["grad_norm"]) / b["grad_norm"]}
             for a, b in zip(metrics_k, metrics_p)]
    log({"phase": "main_path_vs_plain_attention", "model": "efts_transformer_training",
         "losses": [m["loss"] for m in metrics_k], "losses_plain": [m["loss"] for m in metrics_p],
         "max_loss_rel": max(d["loss_rel"] for d in diffs),
         "max_grad_norm_rel": max(d["grad_norm_rel"] for d in diffs), "tolerance": TRAIN_TOL})
    if any(d["loss_rel"] > TRAIN_TOL["loss_rel"] or d["grad_norm_rel"] > TRAIN_TOL["grad_norm_rel"] for d in diffs):
        raise AssertionError(f"training through the kernels disagrees with the plain path: {diffs}")

    # 4d. the published yaml, dropout 0.1: every attention call takes the XLA branch
    drop_cfg = dataclasses.replace(train_cfg, dropout_rate=0.1)
    fa.reset_launches()
    drop_gen = torch.Generator().manual_seed(0)
    state_d, step_d, metrics_d, _ = run_steps(trainable(drop_cfg), drop_cfg, 3, drop_gen)
    log({"phase": "main_path", "model": "efts_transformer_training_dropout", "steps": 3, "metrics": metrics_d,
         "flash_launches": {"/".join(map(str, k)): n for k, n in fa.launches.items()}})
    if fa.launches:
        raise AssertionError(f"training with dropout launched flash kernels: {fa.launches}")

    # 4f. the benchmarks' entry points, once each: every version a first call,
    # then warmup and timed calls
    bench_calls = 1 + bench.WARMUP + bench.ITERS
    mrf.reset_launches()
    mrf_int8.reset_launches()
    fused = bench_mrf.main([])
    torch.cuda.synchronize()
    int8_launches = dict(mrf_int8.launches)
    expected = {(kind, 32): 18 * bench_calls for kind in ("dynamic", "static")}
    expected["absmax", 32] = bench_calls
    log({"phase": "main_path", "what": "bench.mrf_fused", **fused, "int8_launches": keyed(int8_launches),
         "expected": keyed(expected), "mrf_launches": keyed(mrf.launches)})
    if int8_launches != expected or mrf.launches != {("bf16", 32): 18 * bench_calls}:
        raise AssertionError(f"bench.mrf_fused launched {int8_launches} and {mrf.launches}, expected {expected}")
    pm.reset_launches()
    probe = bench_probe.main([])
    torch.cuda.synchronize()
    probe_launches = dict(pm.launches)
    log({"phase": "main_path", "what": "bench.probe_int8", **probe, "launches": probe_launches})
    if probe_launches != {"bf16": bench_calls, "int8": bench_calls}:
        raise AssertionError(f"bench.probe_int8 launched {probe_launches}")

    # 4g. narrow generators: EFTS-CNN into the V2-width and the narrow
    # vocoder, bf16 and f32; stages whose width is not a multiple of 32 run
    # the MRF kernels padded to the next one
    narrow_launches = {}
    for vname, c0 in NARROW_VOCODERS.items():
        ncfg = dataclasses.replace(voc_cfg, upsample_initial_channel=c0)
        nvoc = compat.hifigan_generator_from_jax(init.init_generator(4, ncfg), ncfg, device="cuda")
        widths = [c0 // 2 ** (i + 1) for i in range(len(ncfg.upsample_rates))]
        for cdt, dname in ((bf16, "bf16"), (None, "f32")):
            def synth(impl="kernel"):
                return pipeline.synthesize_fixed(efts, nvoc, *batches[0], T2, compute_dtype=cdt, mrf_impl=impl)

            mrf.reset_launches()
            wav, wl, mel = synth()
            torch.cuda.synchronize()
            got = narrow_launches[vname, dname] = dict(mrf.launches)
            expected = {}
            for c in widths:
                key = (dname, mrf.kernel_channels(c))
                expected[key] = expected.get(key, 0) + 18
            check_fixed(torch, wav, mel, T2, hop, efts_cfg.odim)
            wav_plain, wl_plain, _ = synth("plain")
            stats = err_stats(wav, wav_plain)
            if dname == "bf16":
                tol, ok = WAV_TOL, within(stats, WAV_TOL)
            else:
                tol = F32_WAV_TOL
                ok = stats["max_abs_err"] <= tol["max_abs"] and stats["rel_rms"] <= tol["rel_rms"]
            log({"phase": "main_path_vs_plain_mrf", "model": "efts_cnn", "vocoder": vname, "widths": widths,
                 "dtype": dname, "t2": T2, "mrf_launches": keyed(got), "expected": keyed(expected), **stats,
                 "tolerance": tol, "ms": time_ms(synth)["median"], "plain_mrf_ms": time_ms(lambda: synth("plain"))["median"]})
            if got != expected or not torch.equal(wl, wl_plain) or not ok:
                raise AssertionError(f"{vname} in {dname}: launches {got} (expected {expected}), {stats}")
            del wav, wav_plain, mel
        del nvoc

    # 4h. the streaming paths at full width: EFTS-CNN -> HiFi-GAN V1, one
    # batch's mels (B=16, T2=512) from decode_mel_fixed, f32 and bf16. Random
    # weights give about 1.8 frames a token; this duration bias gives about
    # 5 (the longest utterance of the batch 482 frames), the shape of
    # bench.py's T1=96 -> T2=512, so an utterance streams in 8 chunks
    from efficient_tts_tpu_torch.models.hifigan import generator_chunked

    long_params = init.init_efts(0, efts_cfg)
    long_params["duration_predictor"]["out"]["b"][:] = 0.8
    efts_long = compat.efts_cnn_from_jax(long_params, efts_cfg, device="cuda")

    new_launches = {}
    for cdt, dname in ((None, "f32"), (bf16, "bf16")):
        mrf.reset_launches()
        mel, mel_len = pipeline.decode_mel_fixed(efts_long, *batches[0], T2, compute_dtype=cdt)
        torch.cuda.synchronize()
        if mrf.launches or mel.shape != (B, T2, efts_cfg.odim) or not bool(torch.isfinite(mel).all()):
            raise AssertionError(f"decode_mel_fixed gave {tuple(mel.shape)}, MRF launches {mrf.launches}")
        with torch.inference_mode():
            full = voc(mel, compute_dtype=cdt)
        mrf.reset_launches()
        chunked = generator_chunked(voc, mel, compute_dtype=cdt, chunk_frames=256, overlap_frames=24)
        torch.cuda.synchronize()
        got = new_launches["efts_cnn_chunked", dname] = dict(mrf.launches)
        n_win = -(-T2 // 256)
        stats = err_stats(chunked, full)
        ok = stats["max_abs_err"] <= CHUNK_F32_ATOL if cdt is None else within(stats, WAV_TOL)
        log({"phase": "main_path_vs_full_pass", "what": "generator_chunked", "dtype": dname, "shape": list(mel.shape),
             "chunk_frames": 256, "overlap_frames": 24, "windows": n_win, "mrf_launches": keyed(got), **stats,
             "bit_equal": bool(torch.equal(chunked, full)),
             "tolerance": {"max_abs": CHUNK_F32_ATOL} if cdt is None else WAV_TOL,
             "ms": time_ms(lambda: generator_chunked(voc, mel, compute_dtype=cdt, chunk_frames=256))["median"],
             "full_pass_ms": time_ms(lambda: voc(mel, compute_dtype=cdt))["median"]})
        if got != stage_launches(stages, dname, n_win) or not ok:
            raise AssertionError(f"generator_chunked in {dname}: launches {got}, {stats}")
        # one utterance streamed in chunks of 64 frames, joined, against its full pass
        n0 = int(mel_len[0])
        mel0 = mel[0, :n0].float().cpu().numpy()

        def full_pass():
            with torch.inference_mode():
                return voc(mel[:1, :n0].contiguous(), compute_dtype=cdt)[0].cpu().numpy()

        def first_chunk():
            return next(pipeline.stream_vocoder(voc, mel0, chunk_frames=64, overlap_frames=24, compute_dtype=cdt))

        mrf.reset_launches()
        chunks = list(pipeline.stream_vocoder(voc, mel0, chunk_frames=64, overlap_frames=24, compute_dtype=cdt))
        got = new_launches["efts_cnn_streamed", dname] = dict(mrf.launches)
        ref0 = torch.from_numpy(full_pass())
        joined = torch.from_numpy(np.concatenate(chunks))
        stats = err_stats(joined, ref0)
        ok = stats["max_abs_err"] <= CHUNK_F32_ATOL if cdt is None else within(stats, WAV_TOL)
        ttfc, full_ms = wall_ms(torch, first_chunk), wall_ms(torch, full_pass)
        log({"phase": "main_path_vs_full_pass", "what": "stream_vocoder", "dtype": dname, "frames": n0,
             "chunk_frames": 64, "overlap_frames": 24, "chunks": len(chunks), "mrf_launches": keyed(got), **stats,
             "bit_equal": bool(torch.equal(joined, ref0)),
             "tolerance": {"max_abs": CHUNK_F32_ATOL} if cdt is None else WAV_TOL,
             "first_chunk_ms": ttfc, "full_pass_ms": full_ms, "first_chunk_over_full_pass": ttfc / full_ms})
        if len(chunks) < 3 or got != stage_launches(stages, dname, len(chunks)) or not ok:
            raise AssertionError(f"stream_vocoder in {dname} over {n0} frames: launches {got}, {stats}")
        del mel, full, chunked, chunks
    # the MRF kernels alone on a streamed window (mel frames 40..152, the second
    # window of stream_vocoder): its rows past the stage's halo are the full
    # stage's rows bit for bit, in bf16 and in f32
    halo = mrf_halo(ks, ds)
    for dtype in (bf16, torch.float32):
        for c, t in stages:
            x, ws, bs, order = stage_inputs(torch, c, t, seed=c, dev=dev, kernel_sizes=ks, dilation_sizes=ds,
                                            dtype=dtype)
            x = x[:2].contiguous()
            kw = mrf.kernel_weights(ws)
            up = t // T2
            w0, w1 = 40 * up, 152 * up
            full = mrf.mrf_stage(x, kw, bs, ks, ds)
            win = mrf.mrf_stage(x[:, w0:w1].contiguous(), kw, bs, ks, ds)
            torch.cuda.synchronize()
            stats = err_stats(win[:, halo:-halo], full[:, w0 + halo:w1 - halo])
            log({"phase": "kernel_window_interior", "dtype": str(dtype).split(".")[-1], "channels": c,
                 "window_rows": [w0, w1], "halo": halo, **stats, "tolerance": "bit-equal"})
            if stats["max_abs_err"] != 0.0:
                raise AssertionError(f"the MRF kernel on a window differs from the full stage at C={c}: {stats}")
            del x, ws, bs, kw, full, win

    # 4i. dispatch with the fetch one batch late: 4 ragged batches, each
    # fetched only after the next is dispatched, against synthesize_fixed
    d_batches = ragged_batches(np.random.default_rng(3), T1, efts_cfg.num_symbols, n=4)

    def dispatch_loop(cdt):
        """Dispatch batch n + 1, then fetch batch n; the waveforms, lengths and
        the timings of each batch (with the host's wait in fetch)."""
        results, pending = [], None
        for batch in [*d_batches, None]:
            nxt = None
            if batch is not None:
                tm = {}
                nxt = (*pipeline.synthesize_dispatch(efts_long, voc, *batch, compute_dtype=cdt, timings=tm), tm)
            if pending is not None:
                t0 = time.perf_counter()
                wav = pipeline.fetch(pending[0])
                pending[2]["fetch_s"] = time.perf_counter() - t0
                results.append((wav, pending[1], pending[2]))
            pending = nxt
        return results

    for cdt, dname in ((None, "f32"), (bf16, "bf16")):
        mrf.reset_launches()
        results = dispatch_loop(cdt)
        got = new_launches["efts_cnn_dispatch", dname] = dict(mrf.launches)
        for (text, lengths), (wav, wl, tm) in zip(d_batches, results):
            wav_f, wl_f, _ = pipeline.synthesize_fixed(efts_long, voc, text, lengths, tm["t2"], compute_dtype=cdt)
            if not (torch.equal(torch.from_numpy(wav), wav_f.cpu()) and np.array_equal(wl, wl_f.cpu().numpy())):
                raise AssertionError(f"a dispatched batch in {dname} differs from synthesize_fixed at t2={tm['t2']}: "
                                     f"{err_stats(torch.from_numpy(wav), wav_f.cpu())}")
        loop_ms = wall_ms(torch, lambda: dispatch_loop(cdt), n=3)
        prof = device_profile(torch, lambda: dispatch_loop(cdt), n=1)
        busy = sum(v[0] for v in prof.values()) if prof else None
        log({"phase": "main_path", "what": "synthesize_dispatch + fetch one batch late", "dtype": dname,
             "batches": len(results), "mrf_launches": keyed(got), "equal_to_synthesize_fixed": True,
             "timings": [tm for _, _, tm in results], "loop_ms": loop_ms,
             "device_busy_ms": busy if busy is not None else "not measured",
             "idle_share": max(0.0, 1.0 - busy / loop_ms) if busy is not None else "not measured"})
        if got != stage_launches(stages, dname, len(d_batches)):
            raise AssertionError(f"the dispatched batches in {dname} launched {got}")
        del results

    # 4j. ResBlock2: EFTS-CNN into a generator at HiFi-GAN V3's widths (no kernel)
    v3_cfg = HiFiGANConfig(resblock="2", upsample_rates=(8, 8, 4), upsample_kernel_sizes=(16, 16, 8),
                           upsample_initial_channel=256, resblock_kernel_sizes=(3, 5, 7),
                           resblock_dilation_sizes=((1, 2), (2, 6), (3, 12)))
    voc3 = compat.hifigan_generator_from_jax(init.init_generator(5, v3_cfg), v3_cfg, device="cuda")
    v3_wavs = {}
    for cdt, dname in ((None, "f32"), (bf16, "bf16")):
        def synth3():
            return pipeline.synthesize_fixed(efts, voc3, *batches[0], T2, compute_dtype=cdt)

        mrf.reset_launches()
        wav, wl, mel = synth3()
        torch.cuda.synchronize()
        check_fixed(torch, wav, mel, T2, v3_cfg.hop_size, efts_cfg.odim)
        if mrf.launches:
            raise AssertionError(f"the ResBlock2 generator launched MRF kernels: {mrf.launches}")
        v3_wavs[dname] = wav
        log({"phase": "main_path", "what": "synthesize_fixed, ResBlock2 (V3 widths)", "dtype": dname, "B": B,
             "T2": T2, "wav_shape": list(wav.shape), "finite": True, "ms": time_ms(synth3)["median"],
             "vocoder_ms": time_ms(lambda: voc3(mel, compute_dtype=cdt))["median"],
             **({"vs_f32": err_stats(wav, v3_wavs["f32"])} if dname == "bf16" else {})})
    del voc3, v3_wavs

    # 4k. the serving engine, its HTTP server and stream on the card, and the
    # inference CLI; 4l. the load bench through the warm engines
    serve_flash = {}
    engines = serving_phase(torch, voc, stages, new_launches, serve_flash)
    inference_cli_phase(torch, voc, stages, new_launches)
    load_bench_phase(torch, engines, new_launches)
    del engines

    # 4m. EFTS-CNN training on a synthetic corpus through the training CLI,
    # inference from its checkpoint, and the EFTS-Transformer through the CLI;
    # 4n. HiFi-GAN training on the same corpus, GTA mels from 4m's checkpoint
    import tempfile

    with tempfile.TemporaryDirectory() as work:
        train_cli_flash, trained = corpus_training_phase(torch, voc, stages, new_launches, work)
        vocoder = vocoder_training_phase(torch, stages, new_launches, trained)
        # 4o. the vocoder corpus on the card, a registry optimizer, the DurationModel
        registry_flash = device_corpus_phase(torch, stages, new_launches, vocoder, trained)
        # 4p. the reference's file formats, the tooling CLIs, profiling and plots
        time_step_ms = reference_io_phase(torch, stages, new_launches, vocoder, trained,
                                          lambda: pipeline.synthesize_fixed(efts, voc, *batches[0], T2))
        del vocoder
    # 4q. multi-rank synthesis and serving, the ranks on this card
    with tempfile.TemporaryDirectory() as work:
        multi_rank_flash = multi_rank_phase(torch, new_launches, work)
    # 4r. training over ranks, the ranks on this card
    with tempfile.TemporaryDirectory() as work:
        multi_rank_training_flash = multi_rank_training_phase(torch, new_launches, work)
    # the flash kernels at the CLI's other lengths, held as phase 3 holds
    # them at T=512 and T=128 (the corpus's buckets give T of 128-896)
    cli_shapes = sorted({(t, seg) for (_, t, _, seg) in (*train_cli_flash, *registry_flash)} - set(bwd_shapes))
    for t, segmented in cli_shapes:
        flash_rows[f"train_cli_t{t}"] = check_flash_backward(torch, fa, t, segmented, dev, bwd_rows)

    # 5. timing
    def time_path(name, model, text, lengths, plain_model, plain_kw, extra, cdt=bf16, time_step_ms=None):
        """`synthesize_fixed` with the kernels, and with one kernel's plain
        version; `time_step_ms`, 4p's `utils.profiling.time_step` of the same
        call, is printed beside and must agree within 10%."""
        t_kernel = time_ms(lambda: pipeline.synthesize_fixed(model, voc, text, lengths, T2,
                                                                     compute_dtype=cdt))
        t_plain = time_ms(lambda: pipeline.synthesize_fixed(
            plain_model, voc, text, lengths, T2, compute_dtype=cdt, **plain_kw))
        ms = t_kernel["median"]
        audio_s = B * T2 * hop / voc_cfg.sampling_rate
        dtype = "f32" if cdt is None else "bf16"
        # MFU of EFTS-CNN's synthesis (`utils/flops.py`, bench.py's counts:
        # 5.19 TFLOP a batch) over the card's dense peak for the dtype
        mfu = {}
        if name == "efts_cnn":
            work = (flop_counts.efts_cnn_infer_flops(efts_cfg, B, text.shape[1], T2)
                    + flop_counts.generator_flops(voc_cfg, B, T2))
            peak = flop_counts.peak_flops_for(torch.cuda.get_device_name(0), cdt)
            mfu = {"flops": work, "peak_flops": peak, "mfu": work / (ms / 1e3) / peak if peak else None}
        log({"phase": "timing", "what": "synthesize_fixed", "model": name, "B": B, "T1": text.shape[1],
             "T2": T2, "dtype": dtype, "ms": ms, "ms_p25": t_kernel["p25"], "ms_p75": t_kernel["p75"],
             "n": t_kernel["n"], "audio_s_per_s": audio_s / (ms / 1e3), extra: t_plain["median"], **mfu,
             **({"utils_profiling_time_step_ms": time_step_ms} if time_step_ms else {})})
        if time_step_ms and abs(time_step_ms / ms - 1) > 0.10:
            raise AssertionError(f"utils.profiling.time_step gave {time_step_ms} ms against {ms} ms here")
        prof = device_profile(torch, lambda: pipeline.synthesize_fixed(model, voc, text, lengths, T2,
                                                                       compute_dtype=cdt))
        summary = (profile_summary(prof, ms, (*MRF_KERNELS.values(), "flash_fwd_kernel"))
                   if prof else {"device_busy_ms": "not measured"})
        log({"phase": "profile", "what": "synthesize_fixed", "model": name, "dtype": dtype, **summary})
        # every MRF conv of the 4 stages went through the kernel of its dtype
        if prof and summary[MRF_KERNELS[dtype] + "_launches"] != 18 * len(stages):
            raise AssertionError(f"the profile shows {summary[MRF_KERNELS[dtype] + '_launches']} MRF kernel "
                                 f"launches per synthesis, expected {18 * len(stages)}")

    time_path("efts_cnn", efts, *batches[0], efts, {"mrf_impl": "plain"}, "plain_mrf_ms")
    time_path("efts_transformer", tr, *tr_batches[0], tr_plain, {}, "plain_attention_ms")
    time_path("efts_cnn", efts, *batches[0], efts, {"mrf_impl": "plain"}, "plain_mrf_ms", cdt=None,
              time_step_ms=time_step_ms)
    time_path("efts_transformer", tr, *tr_batches[0], tr, {"mrf_impl": "plain"}, "plain_mrf_ms", cdt=None)
    del efts, tr, tr_plain

    # the training step after warmup: the kernel path, the plain attention and
    # the published yaml's dropout (each state keeps training as it is timed)
    flash_names = tuple(FLASH_KERNELS.values())
    for name, (state, step, gen) in {"flash": (state_k, step_k, None), "flash_plain": (state_p, step_p, None),
                                     "dropout_0.1": (state_d, step_d, drop_gen)}.items():
        t_step = time_ms(lambda: step(state, batch, gen))
        prof = device_profile(torch, lambda: step(state, batch, gen))
        summary = profile_summary(prof, t_step["median"], flash_names) if prof else {"device_busy_ms": "not measured"}
        log({"phase": "timing", "what": "train_step", "attention": name, "B": TRAIN_B, "T1": T1_TR,
             "T2": TRAIN_T2, "dtype": "f32", "ms": t_step["median"], "ms_p25": t_step["p25"],
             "ms_p75": t_step["p75"], "n": t_step["n"], "steps_done": state["step"], **summary})
        # the kernel path's step runs each flash kernel once per attention call
        want = n_t1 + n_t2 if name == "flash" else 0
        if prof and any(summary[k + "_launches"] != want for k in flash_names):
            raise AssertionError(f"the {name} step's profile shows flash launches "
                                 f"{ {k: summary[k + '_launches'] for k in flash_names} }, expected {want} each")
        if name == "flash" and not prof:
            raise AssertionError("the profiler saw no device time in the flash training step")
    del state_k, state_p, state_d, step_k, step_p, step_d, model_k, model_p

    kernels = []
    # the MRF stage kernels at the V1 stage shapes: bf16 (K1) and f32 (K3),
    # their weights prepared once (TF32 split, TMA descriptors) as the
    # generator prepares them
    for dtype, rows, tol in ((bf16, kernel_rows, STAGE_TOL), (torch.float32, f32_rows, F32_STAGE_TOL)):
        f32 = dtype == torch.float32
        dname = "f32" if f32 else "bf16"
        for c, t in stages:
            x, ws, bs, order = stage_inputs(torch, c, t, seed=c, dev=dev, kernel_sizes=ks, dilation_sizes=ds,
                                            dtype=dtype)
            kw = mrf.kernel_weights(ws)
            mrf.reset_launches()
            mrf.mrf_stage(x, kw, bs, ks, ds)
            per_stage = mrf.launches.get((dname, c), 0)
            if per_stage != len(order):
                raise AssertionError(f"one {dname} stage at C={c} launched {mrf.launches}, expected {len(order)}")
            t_k = time_ms(lambda: mrf.mrf_stage(x, kw, bs, ks, ds))
            k_ms = t_k["median"]
            p_ms = time_ms(lambda: mrf.mrf_stage_reference(x, ws, bs, ks, ds))["median"]
            lib_ms = time_ms(cudnn_convs(torch, x, ws, bs, order))["median"]
            bound, bound_by, flops = stage_bound_ms(c, t, order, "tf32x3" if f32 else "bf16")
            key = (dname, c)
            by_path = ({name: f32_launches[name].get(key, 0) for name in f32_launches} if f32
                       else {"efts_cnn": launches.get(key, 0), "efts_transformer": tr_launches.get(key, 0)})
            by_path.update({f"efts_cnn_{v}": narrow_launches[v, dname].get(key, 0) for v in NARROW_VOCODERS})
            by_path.update({path: n.get(key, 0) for (path, dn), n in new_launches.items() if dn == dname})
            row = {
                "name": f"mrf_stage_{'f32_' if f32 else ''}c{c}", "route": "cuda",
                "source": "efficient_tts_tpu_torch/csrc/mrf_stage.cu",
                "replaces": ("efficient_tts_tpu/ops/pallas/mrf.py:203" if f32
                             else "efficient_tts_tpu/ops/pallas/mrf_packed.py:284"),
                "launches": by_path["efts_cnn"], "launches_by_path": by_path, "launches_per_stage": per_stage,
                **rows[c], "tolerance": tol,
                "precision": "3xTF32 products, f32 sums" if f32 else "bf16 operands, f32 sums, bf16 rounding points",
                "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound, "bound_by": bound_by, "library_ms": lib_ms,
                "library_call": f"the stage's 18 F.conv1d (cuDNN) in {'f32, TF32 off' if f32 else 'bf16'}",
            }
            peaks = {"tf32x3": "TF32/3 165 TFLOP/s"} if f32 else {"bf16": "bf16 989 TFLOP/s"}
            if f32:
                row["bound_ms_fp32"] = stage_bound_ms(c, t, order, "fp32")[0]
                peaks["fp32"] = "FP32 67 TFLOP/s"
            kernels.append(row)
            log({"phase": "timing", "what": row["name"], "shape": [B, t, c], "tflops": flops / (k_ms * 1e9),
                 "bound_share": bound / k_ms, "ms_p25": t_k["p25"], "ms_p75": t_k["p75"], "n": t_k["n"],
                 "peak_used": peaks, "vs_library": k_ms / lib_ms,
                 **{k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                        "launches_per_stage")},
                 **({"bound_ms_fp32": row["bound_ms_fp32"]} if f32 else {})})
            del x, ws, bs, kw

    # the W8A8 kernel at the bench's shape: its times from bench.mrf_fused's
    # run above, beside K1 and the cuDNN bf16 stage there; its plain version
    # and the stage's 18 bare cuDNN bf16 convs timed here
    c, t = INT8_SHAPES[-1]
    st = bench_mrf.make_stage(B, t * c // bench_mrf.LANES, c, dev)
    lib_ms = time_ms(cudnn_convs(torch, st["x"], st["w_bf16"], st["biases"], st["order"]))["median"]
    bound, bound_by, flops = stage_bound_ms(c, t, st["order"], "int8")
    from efficient_tts_tpu_torch.utils.roofline import PEAK_BYTES, mrf_stage_launch_bytes

    floor = mrf_stage_launch_bytes(B, t, c, ds)
    for kind, act, version in (("dynamic", None, "kernel int8"), ("static", st["act_scales"], "kernel int8-static")):
        args = (st["x"], st["wq"], st["scales"], st["biases"], ks, ds, act)
        p_ms = time_ms(lambda: mrf_int8.mrf_stage_int8_reference(*args), iters=5, warmup=1)["median"]
        k_ms = fused["times"][version]["median"]
        row = {
            "name": f"mrf_stage_int8_{kind}_c{c}", "route": "cuda",
            "source": "efficient_tts_tpu_torch/csrc/mrf_stage_int8.cu",
            "replaces": "efficient_tts_tpu/ops/pallas/mrf_packed.py:284",
            "launches": int8_launches.get((kind, c), 0),
            "launches_by_path": {"bench.mrf_fused": int8_launches.get((kind, c), 0),
                                 "bench.mrf_fused absmax": int8_launches.get(("absmax", c), 0) if act is None else 0},
            "max_abs_err": 0.0, "tolerance": "bit-equal",
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound, "bound_by": bound_by, "library_ms": lib_ms,
            "library_call": "the stage's 18 F.conv1d (cuDNN) in bf16",
            "k1_bf16_ms": fused["times"]["kernel bf16"]["median"],
            "cudnn_bf16_stage_ms": fused["times"]["cudnn bf16"]["median"],
            # not the bound: what 18 unfused launches must move (and the absmax read)
            "launch_floor_ms": (floor["bytes"] + (floor["absmax_bytes"] if act is None else 0)) / PEAK_BYTES * 1e3,
        }
        kernels.append(row)
        log({"phase": "timing", "what": row["name"], "shape": [B, t, c], "tops": flops / (k_ms * 1e9),
             "bound_share": bound / k_ms, "peak_used": "int8 1979 TOP/s",
             "launch_floor_share": row["launch_floor_ms"] / k_ms,
             **{k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "k1_bf16_ms",
                                    "cudnn_bf16_stage_ms", "launch_floor_ms")}})
    del st, args

    # the probe at [2^20, 128] x [128, 128] x 8: its times and the library's
    # chains from bench.probe_int8's run above, its plain version timed here
    from efficient_tts_tpu_torch.utils.roofline import bound_ms, probe_work

    for name, (x, w) in bench_probe.make_inputs(bench_probe.M, dev).items():
        p_ms = time_ms(lambda: pm.probe_matmul_reference(x, w))["median"]
        ops, nbytes = probe_work(x.shape[0], bench_probe.REPEAT, x.element_size())
        bound, bound_by = bound_ms(ops, nbytes, name)
        k_ms = probe["times"][f"kernel {name}"]["median"]
        row = {
            "name": f"probe_matmul_{name}", "route": "cuda",
            "source": "efficient_tts_tpu_torch/csrc/probe_matmul.cu",
            "replaces": "scripts/probe_int8_pallas.py:42",
            "launches": probe_launches.get(name, 0), "launches_by_path": {"bench.probe_int8": probe_launches.get(name, 0)},
            **probe_rows[name], "tolerance": PROBE_BF16_TOL if name == "bf16" else "bit-equal",
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound, "bound_by": bound_by,
            "library_ms": probe["times"][f"torch {name}"]["median"],
            "library_call": "8 x torch.matmul (bf16)" if name == "bf16" else "8 x torch._int_mm, each cast to int8",
        }
        kernels.append(row)
        log({"phase": "timing", "what": row["name"], "shape": list(x.shape), "tflops": ops / (k_ms * 1e9),
             "bound_share": bound / k_ms, "peak_used": f"{name} {'989' if name == 'bf16' else '1979'} T/s",
             **{k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}})
        del x, w
    log({"phase": "timing", "what": "probe_matmul int8:bf16 rate ratio", "kernel": probe["int8_over_bf16_rate"],
         "library": probe["times"]["torch bf16"]["median"] / probe["times"]["torch int8"]["median"],
         "peaks": 1979 / 989})

    cli_fwd_shapes = tuple((f"train_cli_t{t}", TRAIN_B, t, segmented) for t, segmented in cli_shapes)
    sp_fwd_shapes = tuple((f"sp_t{tq}_{tk}", TRAIN_B, tq, True, tk) for tq, tk in SP_FLASH_SHAPES)
    for name, fb, t, segmented, *keys in FLASH_FWD_SHAPES + cli_fwd_shapes + sp_fwd_shapes:
        tk = keys[0] if keys else None
        q, k, v, seg = flash_inputs(torch, t, seed=t + (tk or 0), dev=dev, segmented=segmented, b=fb, tk=tk)
        scale = 96**-0.5
        mask = None if seg is None else (seg.q[:, None, :, None] == seg.kv[:, None, None, :])
        training = fb == TRAIN_B  # the training path asks for the residuals m, l
        # the library computes the rows the function needs (not a padded q's)
        q_rows, mask_rows = q[:, :, :t], None if mask is None else mask[:, :, :t]
        calls = {
            "kernel": lambda: fa._forward_kernel(q, k, v, seg, scale, residuals=training),
            "plain": lambda: fa.flash_attention_reference(q, k, v, seg, scale, return_residuals=training),
            "library": lambda: F.scaled_dot_product_attention(q_rows, k, v, attn_mask=mask_rows, scale=scale),
        }
        # the kernel's device time per launch that the profile recorded (it
        # may miss launches of the first calls); beside it the per-call sum
        # over every kernel of the window, the reading of earlier rows, and
        # the kernels the window held
        prof = device_profile(torch, calls["kernel"], n=N_TIMED)
        k_queued = queued_ms(torch, calls["kernel"])
        per_launch = launch_ms(torch, calls["kernel"], (FLASH_KERNELS["fwd"],)).get(FLASH_KERNELS["fwd"])
        # a profiler that never recorded the kernel leaves the queued-event time
        k_dev, launches_seen = per_launch if per_launch else (k_queued, 0.0)
        dev_ms = {name_: device_ms(torch, fn) for name_, fn in calls.items() if name_ != "kernel"}
        call_ms = {name_: time_ms(fn) for name_, fn in calls.items()}
        k_host_us = host_us(torch, calls["kernel"])
        ms = {name_: dev_ms[name_] if dev_ms[name_] is not None else call_ms[name_]["median"] for name_ in dev_ms}
        bound, bound_by, flops = flash_bound_ms(q, k, seg, rows=t)
        key = ("fwd", q.shape[2], k.shape[2], True)
        if not training:
            by_path = {"efts_transformer": tr_flash.get(segmented, 0),
                       "serve_engine_transformer": serve_flash.get(segmented, 0),
                       **{path: n.get(segmented, 0) for path, n in multi_rank_flash.items()}}
        else:
            by_path = {"efts_transformer_training": train_launches.get(key, 0),
                       "train_cli_transformer": train_cli_flash.get(key, 0),
                       "train_cli_transformer_registry_optimizer": registry_flash.get(key, 0),
                       **{path: n.get(key, 0) for path, n in multi_rank_training_flash.items()}}
        # a length only the CLI's corpus gives counts the CLI's launches; a
        # sequence-parallel rank's rows, 4r's ranks' launches summed
        n_launch = (sum(by_path.values()) if tk else
                    by_path["train_cli_transformer" if name.startswith("train_cli") else next(iter(by_path))])
        row = {
            "name": "flash_attention_fwd_" + name, "route": "cuda",
            "source": "efficient_tts_tpu_torch/csrc/flash_attention.cu",
            "replaces": "efficient_tts_tpu/nn/attention.py:56",
            "pallas_call": "jax/experimental/pallas/ops/tpu/flash_attention.py:758 (jax 0.9.0)",
            "launches": n_launch, "launches_by_path": by_path,
            **flash_rows[name], "tolerance": FLASH_TOL, "precision": "tf32 operands, f32 softmax and sums",
            "ms": k_dev, "plain_ms": ms["plain"], "bound_ms": bound, "bound_by": bound_by,
            "library_ms": ms["library"], "library_call": "F.scaled_dot_product_attention, f32, boolean mask",
            "timed_by": "device" if per_launch else "queued events", "launches_recorded_per_call": launches_seen,
        }
        kernels.append(row)
        log({"phase": "timing", "what": row["name"], "shape": list(q.shape), "keys": k.shape[2], "rows": t,
             "segment_ids": segmented, "residuals": training, "tflops": flops / (k_dev * 1e9),
             "bound_share": bound / k_dev,
             "per_call_all_kernels_ms": sum(v_[0] for v_ in prof.values()), "queued_event_ms": k_queued,
             "window_kernels": {key[:60]: v_ for key, v_ in prof.items()},
             "call_ms": {name_: v_["median"] for name_, v_ in call_ms.items()},
             "kernel_call_ms_p25": call_ms["kernel"]["p25"], "kernel_call_ms_p75": call_ms["kernel"]["p75"],
             "kernel_host_us": k_host_us, "peak_used": "TF32 495 TFLOP/s, HBM3 3.35 TB/s",
             **{k_: row[k_] for k_ in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "timed_by",
                                       "launches_recorded_per_call")}})
        del q, k, v, seg, mask, q_rows, mask_rows, calls, prof

    # the backward kernels at the training path's shapes (every call masked):
    # device time of each kernel, of its plain version from the same
    # residuals, and of SDPA's backward (dq, dk and dv in one call)
    pallas_lines = {"dkv": 1121, "dq": 1456}
    for t, tk, segmented in ((TRAIN_T2, None, True), (T1_TR, None, True), *((t, None, s) for t, s in cli_shapes),
                             *((tq, tk, True) for tq, tk in SP_FLASH_SHAPES)):
        q, k, v, do, seg = flash_inputs(torch, t, seed=t + 1 + (tk or 0), dev=dev, segmented=segmented, b=TRAIN_B,
                                        n=4, tk=tk)
        scale = 96**-0.5
        o, m, l = fa._forward_kernel(q, k, v, seg, scale, residuals=True)
        mask = seg.q[:, None, :, None] == seg.kv[:, None, None, :]
        # the library on the rows the function needs (not a padded q's)
        qs, ks_, vs = (x.detach().requires_grad_(True) for x in (q[:, :, :t], k, v))
        lib_out = F.scaled_dot_product_attention(qs, ks_, vs, attn_mask=mask[:, :, :t], scale=scale)
        do_rows = do[:, :, :t]

        def library_bwd():
            return torch.autograd.grad(lib_out, (qs, ks_, vs), do_rows, retain_graph=True)

        def kernel_bwd():
            return fa._backward_kernels(q, k, v, o, m, l, do, seg, scale)

        per_launch = launch_ms(torch, kernel_bwd, (FLASH_KERNELS["dkv"], FLASH_KERNELS["dq"]))
        call_ms = time_ms(kernel_bwd)
        # host time of one backward call: di, the 4 TMA maps each kernel's
        # entry encodes, and the two launches
        bwd_host_us = host_us(torch, kernel_bwd)
        lib_dev = device_ms(torch, library_bwd)
        lib_ms = lib_dev if lib_dev is not None else time_ms(library_bwd)["median"]
        for part in ("dkv", "dq"):
            kname = FLASH_KERNELS[part]
            if kname not in per_launch:
                raise AssertionError(f"three profiles of the backward call did not record {kname}")
            # device time per launch: the profiler may miss launches, so
            # divide by the launches it recorded, not the calls
            k_dev, launches_seen = per_launch[kname]

            def plain(part=part):
                return plain_bwd_part(torch, fa, part, q, k, v, o, m, l, do, seg, scale)

            p_dev = device_ms(torch, plain)
            p_ms = p_dev if p_dev is not None else time_ms(plain)["median"]
            bound, bound_by, flops = flash_bwd_bound_ms(q, k, seg, part, rows=t)
            k_ms = k_dev
            key = (part, q.shape[2], k.shape[2], segmented)
            by_path = {"efts_transformer_training": train_launches.get(key, 0),
                       "train_cli_transformer": train_cli_flash.get(key, 0),
                       "train_cli_transformer_registry_optimizer": registry_flash.get(key, 0),
                       **{path: n.get(key, 0) for path, n in multi_rank_training_flash.items()}}
            cli_only = tk is None and (t, segmented) in cli_shapes
            row = {
                "name": f"flash_attention_{part}_" + (f"sp_t{t}_{tk}" if tk else "text_encoder" if t == T1_TR
                                                      else f"train_cli_t{t}" if cli_only else f"t{t}"),
                "route": "cuda", "source": "efficient_tts_tpu_torch/csrc/flash_attention.cu",
                "replaces": "efficient_tts_tpu/nn/attention.py:56",
                "pallas_call": f"jax/experimental/pallas/ops/tpu/flash_attention.py:{pallas_lines[part]} (jax 0.9.0)",
                # a sequence-parallel rank's rows: 4r's ranks' launches summed
                "launches": (sum(by_path.values()) if tk else
                             by_path["train_cli_transformer" if cli_only else "efts_transformer_training"]),
                "launches_by_path": by_path,
                **bwd_rows[key], "tolerance": BWD_TOL,
                "precision": "tf32 operands, f32 softmax, di and sums",
                "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound, "bound_by": bound_by, "library_ms": lib_ms,
                "library_call": "F.scaled_dot_product_attention backward, f32, boolean mask (dq, dk, dv together)",
                "timed_by": "device", "launches_recorded_per_call": launches_seen,
            }
            kernels.append(row)
            log({"phase": "timing", "what": row["name"], "shape": list(q.shape), "keys": k.shape[2], "rows": t,
                 "segment_ids": segmented, "tflops": flops / (k_ms * 1e9), "bound_share": bound / k_ms,
                 "backward_call_ms": call_ms["median"], "backward_call_ms_p25": call_ms["p25"],
                 "backward_call_ms_p75": call_ms["p75"], "backward_call_host_us": bwd_host_us,
                 "peak_used": "TF32 495 TFLOP/s, HBM3 3.35 TB/s",
                 **{k_: row[k_] for k_ in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "timed_by")}})
        del q, k, v, do, seg, o, m, l, mask, qs, ks_, vs, lib_out, do_rows, per_launch

    # 5b. an earlier tree's kernels in turns with this tree's
    if opts.baseline:
        baseline_phase(torch, os.path.abspath(opts.baseline), dev)

    # 6. result
    log({"kernels": kernels})
    print(card)
    log({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
