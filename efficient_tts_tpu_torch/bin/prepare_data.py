"""Offline data preparation: filelist splits and a mel cache.

    python -m efficient_tts_tpu_torch.bin.prepare_data \\
        --filelist all.txt --outdir data/ --wav_path wavs/ \\
        --dev 100 --test 500 [--extract_mels --mel_cache_dir mels/]

Counterpart of `efficient_tts_tpu/bin/prepare_data.py` (the reference's
recipe preprocessing, `egs/lj/local/data.sh`, `prepare_features.py`,
`prepare_scps.py`): splits a `path|text` filelist into test, dev and train
in its order, and with `--extract_mels` writes each wav's log-mel to
`mel_cache_dir/<base>.mel.npy` ([T2, 80]), the file that
`data/dataset.py:TextMelDataset(mel_cache_dir=...)` reads in place of
computing it, and that it would write itself: `data/dataset.py:compute_mel`
makes both (the native library's decode and mel when it builds, else scipy
and numpy; default `MelConfig`, 22.05 kHz). Existing cache files are kept.
The mels are taken in `--num_workers` spawned processes. Host work: it
touches no device, and the workers never initialize CUDA.
"""

from __future__ import annotations

import argparse
import logging
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor


def get_parser():
    p = argparse.ArgumentParser(description="Prepare filelists and mel caches")
    p.add_argument("--filelist", required=True, help="full corpus filelist (path|text)")
    p.add_argument("--outdir", required=True)
    p.add_argument("--wav_path", default=None, help="directory the filelist's wavs are re-based onto by basename")
    p.add_argument("--dev", type=int, default=100)
    p.add_argument("--test", type=int, default=500)
    p.add_argument("--extract_mels", action="store_true")
    p.add_argument("--mel_cache_dir", default=None, help="default: outdir/mels")
    p.add_argument("--num_workers", type=int, default=8)
    return p


def _extract_one(job) -> str:
    """Write one wav's mel cache file (unless it exists); returns its base name."""
    import numpy as np

    from efficient_tts_tpu_torch.data.dataset import compute_mel

    path, wav_path, cache_dir = job
    wav_file = os.path.join(wav_path, os.path.basename(path)) if wav_path else path
    base = os.path.splitext(os.path.basename(wav_file))[0]
    out = os.path.join(cache_dir, base + ".mel.npy")
    if not os.path.exists(out):
        np.save(out, compute_mel(wav_file))
    return base


def main(argv=None) -> dict:
    """Prepare as the arguments say; returns {split name: its lines}."""
    args = get_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    os.makedirs(args.outdir, exist_ok=True)

    with open(args.filelist, encoding="utf-8") as f:
        lines = [line.rstrip("\n") for line in f if line.strip()]

    n_test, n_dev = args.test, args.dev
    splits = {
        "test": lines[:n_test],
        "dev": lines[n_test: n_test + n_dev],
        "train": lines[n_test + n_dev:],
    }
    for name, chunk in splits.items():
        path = os.path.join(args.outdir, f"{name}.txt")
        with open(path, "w", encoding="utf-8") as f:
            f.write("\n".join(chunk) + ("\n" if chunk else ""))
        logging.info("%s: %d utterances -> %s", name, len(chunk), path)

    if args.extract_mels:
        from efficient_tts_tpu_torch import native

        cache = args.mel_cache_dir or os.path.join(args.outdir, "mels")
        os.makedirs(cache, exist_ok=True)
        logging.info("mels by the %s path", native.backend())  # builds the native library once, before the workers
        jobs = [(line.split("|")[0], args.wav_path, cache) for line in lines]
        with ProcessPoolExecutor(max_workers=args.num_workers, mp_context=multiprocessing.get_context("spawn")) as ex:
            done = list(ex.map(_extract_one, jobs))
        logging.info("extracted %d mels -> %s", len(done), cache)
    logging.info("total %d utterances prepared", len(lines))
    return splits


if __name__ == "__main__":
    main()
