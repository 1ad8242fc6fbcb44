#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`efficient_tts_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises on failure:
  1. device: needs torch.cuda; prints `nvidia-smi` name and power limit;
  2. build: compiles `efficient_tts_tpu_torch/csrc/*.cu` with nvcc;
  3. kernel vs plain version: every MRF stage of the V1 generator (C =
     256/128/64/32 at its main-path length for B=16, T2=512) through the
     Hopper kernel and through `mrf_stage_reference`, on the same bf16
     inputs;
  4. main path at full width (EFTS-CNN with 76 symbols, HiFi-GAN V1, seeded
     random weights through the weight bridge): `synthesize` on a few
     ragged batches and `synthesize_fixed` at T2=512, bf16; checks shapes,
     lengths, finiteness, the MRF launch counts, and one wav against the
     same path with the plain MRF version;
  5. timing with CUDA events (median and quartiles of 20 runs after
     warmup): the end-to-end `synthesize_fixed`, its device time by
     kernel from torch.profiler, and each stage kernel beside its bound,
     its plain version and the 18 cuDNN convs of the stage;
  6. a `{"kernels": [...]}` line, then the card line, then the last line
     `{"ok": true, "device": {...}}`.
Imports nothing of JAX or of the JAX package.
"""

import json
import os
import statistics
import subprocess
import sys
import time

B, T1, T2 = 16, 96, 512
N_TIMED = 20
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12      # H100 SXM HBM3
# Kernel vs plain version: the same bf16 rounding points, but f32 sums of up to
# 11*256 terms taken in another order flip a bf16 rounding now and then, and
# each flip carries down the chain of 6 convs (measured at C=256 on an H100:
# max 2^-6.7 of the range, relative RMS 2.5e-3).
STAGE_TOL = {"max_abs_over_range": 2**-5, "rel_rms": 1e-2}
# whole waveform, kernel vs plain MRF stages on the same weights
WAV_TOL = {"max_abs_over_range": 0.05, "rel_rms": 1e-2}


def log(obj):
    print(json.dumps(obj), flush=True)


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


def time_ms(torch, fn, n=N_TIMED, warmup=2):
    """CUDA-event times of `n` calls after `warmup`: {median, p25, p75, n} in ms."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    q1, q2, q3 = statistics.quantiles(times, n=4)
    return {"median": q2, "p25": q1, "p75": q3, "n": n}


def device_profile(torch, fn, n=3):
    """Device time by kernel name per run of `fn`, from torch.profiler's
    CUDA activity; an empty dict when the profiler saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    kernels = {}
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        kernels[evt.key] = (us / 1e3 / n, evt.count / n)
    return kernels


def stage_inputs(torch, c, t, seed, dev, kernel_sizes, dilation_sizes):
    """Seeded bf16 activations and unit-gain weights (std 1/sqrt(k*C)), so
    every conv of the chain moves the output."""
    from efficient_tts_tpu_torch.ops.mrf import conv_order

    g = torch.Generator().manual_seed(seed)
    order = conv_order(kernel_sizes, dilation_sizes)
    ws = [(torch.randn((k, c, c), generator=g) / (k * c) ** 0.5).to(dev, torch.bfloat16) for k, _ in order]
    bs = (0.1 * torch.randn((len(order), c), generator=g)).to(dev)
    x = torch.randn((B, t, c), generator=g).to(dev, torch.bfloat16)
    return x, ws, bs, order


def stage_bound_ms(c, t, order):
    flops = 2.0 * B * t * c * c * sum(k for k, _ in order)
    nbytes = 2 * B * t * c * 2 + sum(k * c * c * 2 for k, _ in order) + len(order) * c * 4
    by_ops, by_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(by_ops, by_bytes), ("operations" if by_ops >= by_bytes else "bytes"), flops


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np
    import torch.nn.functional as F

    from efficient_tts_tpu_torch import _build, compat, init, pipeline
    from efficient_tts_tpu_torch.models.efficient_tts import EftsCNNConfig
    from efficient_tts_tpu_torch.models.hifigan import HiFiGANConfig
    from efficient_tts_tpu_torch.ops import mrf

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log({"phase": "device", "card": card, "torch": torch.__version__, "cuda": torch.version.cuda})

    # 2. build
    t0 = time.perf_counter()
    built = _build.build(verbose=True)
    for name, info in built.items():
        print(f"--- nvcc {name} ---\n{info['log']}", file=sys.stderr)
    log({"phase": "build", "seconds": time.perf_counter() - t0, "sources": sorted(built)})

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
        out = mrf.mrf_stage(x, ws, bs, ks, ds)
        torch.cuda.synchronize()
        stats = err_stats(out, mrf.mrf_stage_reference(x, ws, bs, ks, ds))
        log({"phase": "kernel_vs_plain", "channels": c, "shape": [B, t, c], **stats, "tolerance": STAGE_TOL})
        if not within(stats, STAGE_TOL):
            raise AssertionError(f"MRF kernel disagrees with its plain version at C={c}: {stats}")
        kernel_rows[c] = {"max_abs_err": stats["max_abs_err"], "rel_rms": stats["rel_rms"]}
        del x, ws, bs, out

    # 4. main path at full width
    efts = compat.efts_cnn_from_jax(init.init_efts(0, efts_cfg), efts_cfg, device="cuda")
    voc = compat.hifigan_generator_from_jax(init.init_generator(1, voc_cfg), voc_cfg, device="cuda")
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(3):
        lengths = rng.integers(T1 // 2, T1 + 1, B).astype(np.int32)
        lengths[0] = T1
        text = np.zeros((B, T1), np.int32)
        for i, n in enumerate(lengths):
            text[i, :n] = rng.integers(1, efts_cfg.num_symbols, n)
        batches.append((text, lengths))
    hop = voc_cfg.hop_size
    bf16 = torch.bfloat16

    mrf.reset_launches()
    results = [pipeline.synthesize(efts, voc, text, lengths, compute_dtype=bf16) for text, lengths in batches]
    wav_fixed, wl_fixed, mel_fixed = pipeline.synthesize_fixed(
        efts, voc, batches[0][0], batches[0][1], T2, compute_dtype=bf16)
    torch.cuda.synchronize()
    launches = dict(mrf.launches)
    n_synth = len(batches) + 1
    expected = {c: 18 * n_synth for c, _ in stages}
    log({"phase": "main_path", "syntheses": n_synth, "mrf_launches": launches, "expected": expected})
    if launches != expected:
        raise AssertionError(f"MRF launches {launches}, expected {expected}")

    for (text, lengths), (wav, wl) in zip(batches, results):
        mel_len = pipeline.predict_lengths(efts, text, lengths).cpu().numpy()
        t2 = wav.shape[1] // hop
        if wav.shape != (B, t2 * hop) or t2 % 64 or not np.all(np.isfinite(wav)):
            raise AssertionError(f"synthesize gave wav {wav.shape}, finite={np.isfinite(wav).all()}")
        if not np.array_equal(wl, np.clip(mel_len, 1, t2) * hop):
            raise AssertionError(f"wav_lengths {wl} do not follow the stage-1 readback {mel_len}")
        if any(np.any(wav[i, n:] != 0) for i, n in enumerate(wl)):
            raise AssertionError("waveform tail beyond wav_lengths is not silent")
    if (wav_fixed.shape != (B, T2 * hop) or mel_fixed.shape != (B, T2, efts_cfg.odim)
            or not bool(torch.isfinite(wav_fixed).all()) or not bool(torch.isfinite(mel_fixed).all())):
        raise AssertionError(f"synthesize_fixed gave wav {tuple(wav_fixed.shape)} mel {tuple(mel_fixed.shape)}")
    wav_plain, wl_plain, _ = pipeline.synthesize_fixed(
        efts, voc, batches[0][0], batches[0][1], T2, compute_dtype=bf16, mrf_impl="plain")
    stats = err_stats(wav_fixed, wav_plain)
    log({"phase": "main_path_vs_plain_mrf", "t2": T2, "wav_lengths": wl_fixed.tolist(), **stats,
         "tolerance": WAV_TOL, "buckets": [int(w.shape[1] // hop) for w, _ in results]})
    if not torch.equal(wl_fixed, wl_plain) or not within(stats, WAV_TOL):
        raise AssertionError(f"synthesize_fixed with the MRF kernel disagrees with the plain path: {stats}")

    # 5. timing
    text, lengths = batches[0]
    t_kernel = time_ms(torch, lambda: pipeline.synthesize_fixed(efts, voc, text, lengths, T2, compute_dtype=bf16))
    t_plain = time_ms(torch, lambda: pipeline.synthesize_fixed(
        efts, voc, text, lengths, T2, compute_dtype=bf16, mrf_impl="plain"))
    ms = t_kernel["median"]
    audio_s = B * T2 * hop / voc_cfg.sampling_rate
    log({"phase": "timing", "what": "synthesize_fixed", "B": B, "T1": T1, "T2": T2, "dtype": "bf16",
         "ms": ms, "ms_p25": t_kernel["p25"], "ms_p75": t_kernel["p75"], "n": t_kernel["n"],
         "audio_s_per_s": audio_s / (ms / 1e3), "plain_mrf_ms": t_plain["median"], "card": card})
    prof = device_profile(torch, lambda: pipeline.synthesize_fixed(efts, voc, text, lengths, T2,
                                                                   compute_dtype=bf16))
    if prof:
        busy = sum(v[0] for v in prof.values())
        mrf_ms = sum(v[0] for k, v in prof.items() if "mrf_conv_kernel" in k)
        top = sorted(prof.items(), key=lambda kv: -kv[1][0])[:8]
        log({"phase": "profile", "what": "synthesize_fixed", "device_busy_ms": busy,
             "idle_share": max(0.0, 1.0 - busy / ms), "mrf_kernel_ms": mrf_ms,
             "kernel_launches": sum(v[1] for v in prof.values()),
             "top": [[k[:90], v[0], v[1]] for k, v in top], "card": card})
    else:
        log({"phase": "profile", "what": "synthesize_fixed", "device_busy_ms": "not measured"})
    del wav_fixed, wav_plain, mel_fixed, results

    kernels = []
    for c, t in stages:
        x, ws, bs, order = stage_inputs(torch, c, t, seed=c, dev=dev, kernel_sizes=ks, dilation_sizes=ds)
        t_k = time_ms(torch, lambda: mrf.mrf_stage(x, ws, bs, ks, ds))
        k_ms = t_k["median"]
        p_ms = time_ms(torch, lambda: mrf.mrf_stage_reference(x, ws, bs, ks, ds))["median"]
        x_ncw = x.transpose(1, 2).contiguous()
        w_ncw = [w.permute(1, 2, 0).contiguous() for w in ws]
        b_bf16 = bs.to(bf16)

        def cudnn_convs():
            for i, (k, d) in enumerate(order):
                F.conv1d(x_ncw, w_ncw[i], b_bf16[i], padding=(k - 1) // 2 * d, dilation=d)

        lib_ms = time_ms(torch, cudnn_convs)["median"]
        bound, bound_by, flops = stage_bound_ms(c, t, order)
        row = {
            "name": f"mrf_stage_c{c}", "route": "cuda",
            "source": "efficient_tts_tpu_torch/csrc/mrf_stage.cu",
            "replaces": "efficient_tts_tpu/ops/pallas/mrf_packed.py:284",
            "launches": launches.get(c, 0), **kernel_rows[c], "tolerance": STAGE_TOL,
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound, "bound_by": bound_by, "library_ms": lib_ms,
        }
        kernels.append(row)
        log({"phase": "timing", "what": row["name"], "shape": [B, t, c], "tflops": flops / (k_ms * 1e9),
             "bound_share": bound / k_ms, "ms_p25": t_k["p25"], "ms_p75": t_k["p75"], "n": t_k["n"],
             "card": card, **{k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}})
        del x, ws, bs, x_ncw, w_ncw

    # 6. result
    log({"kernels": kernels})
    print(card)
    log({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
