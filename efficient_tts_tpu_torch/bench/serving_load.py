"""Serving under load: request latency percentiles at fixed offered rates.

    python -m efficient_tts_tpu_torch.bench.serving_load [--qps 4,16,64] [--compute_dtype float32]

Port of `scripts/bench_serving_load.py`. It drives the serving stack that
`bin/serve.py` wraps (`TTSEngine` + `DynamicBatcher`) with open-loop Poisson
arrivals at each offered rate and reports per-request latency p50/p95/p99
(null for an arm in which every request was shed), the shed counts, the
mean batch, audio-seconds per second and each batch's phases. Random
weights at full width (EFTS-CNN at bench.py's widths with 148 symbols, the
HiFi-GAN V1 generator), with the duration head pinned so that every symbol
takes about 5.5 mel frames: real work through the engine's own bucket
choice. Runs on the NVIDIA card and raises without one; each row carries
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import threading
import time

import numpy as np
import torch

SENTENCES = [
    # about 40 / 90 / 140 symbols after cleaning: three text buckets
    "The quick brown fox jumps over the dog.",
    "Under these circumstances, with proper management, the bean will "
    "thrust forth its radicle quickly.",
    "It is not possible to state with scientific certainty that a "
    "particular small group of fibers come from a certain piece of "
    "clothing, he said slowly.",
]
# log(5.5 frames + the duration offset 1.0): the pinned duration head's bias
PINNED_LOG_DURATION = float(np.log(6.5))


def pinned_efts_params(seed: int = 0):
    """(config, params) of EFTS-CNN at bench.py's widths with 148 symbols,
    seeded random, the duration head's output pinned to about 5.5 frames a
    symbol."""
    from efficient_tts_tpu_torch import init
    from efficient_tts_tpu_torch.models.efficient_tts import EftsCNNConfig

    cfg = EftsCNNConfig(num_symbols=148, dropout_rate=0.0, use_masking=True)
    params = init.init_efts(seed, cfg)
    out = params["duration_predictor"]["out"]
    out["w"] = np.zeros_like(out["w"])
    out["b"] = np.full_like(out["b"], PINNED_LOG_DURATION)
    return cfg, params


def build_engine(compute_dtype=None, legacy: bool = False, detailed: bool = False, max_batch: int = 16):
    """The load bench's engine on the card: `legacy` serves with f32 transfer
    and no dispatch/fetch overlap, `detailed` synchronizes after each
    dispatch to split device time from the copy's wait."""
    from efficient_tts_tpu_torch import compat, init
    from efficient_tts_tpu_torch.models.hifigan import HiFiGANConfig
    from efficient_tts_tpu_torch.serve import TTSEngine

    cfg, params = pinned_efts_params()
    voc_cfg = HiFiGANConfig()
    model = compat.efts_cnn_from_jax(params, cfg)
    voc = compat.hifigan_generator_from_jax(init.init_generator(1, voc_cfg), voc_cfg)
    return TTSEngine(model, voc, max_batch=max_batch, compute_dtype=compute_dtype, pcm16_transfer=not legacy,
                     pipeline_fetch=not legacy, detailed_timing=detailed)


def warm(engine, max_batch: int) -> None:
    """The engine's warmup over the sentences' text buckets (every batch
    bucket, the organic mel bucket and its neighbours), then one mixed
    synthesis for the shapes that mixed residual groups reach."""
    engine.warmup(t1_lengths=sorted({len(engine.encode(s)) for s in SENTENCES}))
    engine.synthesize(list(SENTENCES) * (2 * max_batch // len(SENTENCES) + 1))
    engine.reset_stats()


def _percentile(lat_ms, q):
    return float(np.percentile(lat_ms, q)) if len(lat_ms) else None


def run_load(engine, qps: float, duration_s: float, rng, max_queue=None, deadline_ms=None) -> dict:
    """One arm: Poisson arrivals at `qps` for `duration_s` through a new
    `DynamicBatcher`, then every admitted request waited for."""
    from efficient_tts_tpu_torch.serve import AdmissionError, DynamicBatcher

    batcher = DynamicBatcher(engine, max_wait_ms=10.0, max_queue=max_queue, deadline_ms=deadline_ms)
    engine.reset_stats()
    lat: list = []
    lock = threading.Lock()
    pending = []
    offered = 0

    def on_done(fut, t_submit):
        try:
            fut.result()
        except AdmissionError:
            return  # shed: counted by the batcher
        with lock:
            lat.append(time.perf_counter() - t_submit)

    t_start = time.perf_counter()
    t_end = t_start + duration_s
    i = 0
    try:
        while time.perf_counter() < t_end:
            text = SENTENCES[i % len(SENTENCES)]
            i += 1
            offered += 1
            t_submit = time.perf_counter()
            try:
                fut = batcher.submit(text)
            except AdmissionError:
                time.sleep(rng.exponential(1.0 / qps))
                continue
            fut.add_done_callback(lambda f, t=t_submit: on_done(f, t))
            pending.append(fut)
            time.sleep(rng.exponential(1.0 / qps))
        for f in pending:
            try:
                f.result(timeout=120)
            except AdmissionError:
                pass
    finally:
        batcher.close()
    drain_s = time.perf_counter() - t_end
    wall = duration_s
    lat_ms = np.sort(np.array(lat)) * 1e3
    s = engine.stats
    nb = max(s.batches, 1)
    shed_full, shed_deadline = batcher.shed_counts()
    return {
        "offered_qps": qps,
        "offered": offered,
        "completed": len(lat),
        "shed_queue_full": shed_full,
        "shed_deadline": shed_deadline,
        "shed_pct": 100.0 * (shed_full + shed_deadline) / max(offered, 1),
        "p50_ms": _percentile(lat_ms, 50),
        "p95_ms": _percentile(lat_ms, 95),
        "p99_ms": _percentile(lat_ms, 99),
        "mean_batch": float(np.mean(s.batch_sizes)) if s.batch_sizes else None,
        "batches": s.batches,
        "audio_s_per_s": s.audio_seconds / wall,
        "engine_busy_share": s.compute_seconds / wall,
        "drain_s": drain_s,
        # where a batch's wall time goes, per batch (ms)
        "per_batch_ms": {
            "lock_wait": 1e3 * s.lock_wait_seconds / nb,
            "stage1_readback": 1e3 * s.stage1_seconds / nb,
            "dispatch": 1e3 * s.dispatch_seconds / nb,
            "device_compute": 1e3 * s.device_seconds / nb,
            "wav_fetch": 1e3 * s.fetch_seconds / nb,
            "total": 1e3 * s.compute_seconds / nb,
        },
    }


def main(argv=None):
    from efficient_tts_tpu_torch.bench import card_line, require_card

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--qps", default="4,16,32,64")
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--compute_dtype", default="bfloat16", choices=["bfloat16", "float32"])
    ap.add_argument("--json_out", default=None)
    ap.add_argument("--max_batch", type=int, default=16)
    ap.add_argument("--legacy", action="store_true", help="f32 transfer, no dispatch/fetch overlap")
    ap.add_argument("--max_queue", type=int, default=256, help="admission bound (0 = unbounded)")
    ap.add_argument("--deadline_ms", type=float, default=2000.0, help="queue-wait bound; aged requests are shed "
                    "(0 = none)")
    ap.add_argument("--attribution", action="store_true",
                    help="synchronize after each dispatch to split device time from the copy's wait "
                    "(defeats pipelining: for the phase table, not throughput)")
    args = ap.parse_args(argv)

    require_card()
    card = card_line()
    cdt = torch.bfloat16 if args.compute_dtype == "bfloat16" else None
    engine = build_engine(cdt, legacy=args.legacy, detailed=args.attribution, max_batch=args.max_batch)
    warm(engine, args.max_batch)
    rng = np.random.default_rng(0)
    rows = []
    for qps in [float(q) for q in args.qps.split(",")]:
        row = run_load(engine, qps, args.seconds, rng, max_queue=args.max_queue or None,
                       deadline_ms=args.deadline_ms or None)
        row.update(compute_dtype=args.compute_dtype, card=card)
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(rows, f, indent=1)
    return rows


if __name__ == "__main__":
    main()
