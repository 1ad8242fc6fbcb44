"""Synthesis CLI (counterpart of `efficient_tts_tpu/bin/inference.py`).

    python -m efficient_tts_tpu_torch.bin.inference --test_fid_scp list.txt \
        --checkpoint exp/checkpoint-100000steps --outdir out [--use_cpu]

Reads the `config.yml` beside the checkpoint, rebuilds the acoustic model
and loads the checkpoint written by `train/checkpoint.py:save_checkpoint`
(an EFTS-CNN trainer's checkpoint has its weight norm folded here),
loads the vocoder (a checkpoint of `bin/train_vocoder.py`, its EMA
generator when it has one, else its generator, weight norm folded; or a
reference HiFi-GAN generator file; or a BigVGAN generator file in
NVIDIA/BigVGAN's layout, `{"generator": state_dict}` with its `config.json`
beside it; or random weights with a warning), synthesizes the filelist's texts in batches through
`pipeline.synthesize` in f32 and writes PCM_16 wavs. Runs on the card unless
`--use_cpu` is given; without a card it raises. `--repeats N` runs the set N
times (pass 0 includes the kernels' first build); `--timing_json` writes the
phase breakdown.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time

import numpy as np
import torch


def get_parser():
    p = argparse.ArgumentParser(description="EFTS + HiFi-GAN synthesis on the card")
    p.add_argument("--test_fid_scp", required=True, help="test filelist (path|text)")
    p.add_argument("--checkpoint", required=True, help="acoustic model checkpoint (config.yml beside it)")
    p.add_argument("--outdir", required=True)
    p.add_argument("--vocoder_checkpoint", default=None,
                   help="a bin.train_vocoder checkpoint, a reference HiFi-GAN generator file (torch state dict), "
                   "or a BigVGAN generator file with its config.json beside it")
    p.add_argument("--num_utts", type=int, default=10)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--use_cpu", action="store_true", help="run on the CPU (the default is the card)")
    p.add_argument(
        "--duration_correction", action="store_true",
        help="apply the analytic last-token truncation correction to the predicted durations "
        "(ops/alignment.py:boundary_truncation_correction), gated per utterance at "
        "--duration_correction_threshold of the length (default off: reference parity)")
    p.add_argument("--duration_correction_threshold", type=float, default=0.02,
                   help="relative-bias gate for --duration_correction (0 = always apply)")
    p.add_argument("--repeats", type=int, default=1,
                   help="synthesize the set N times and report the RTF of each pass: pass 0 includes "
                   "the kernels' first build, later passes are the warm rate")
    p.add_argument("--timing_json", default=None,
                   help="write a phase breakdown (model loads, per-batch wall, per-pass RTF)")
    return p


def load_acoustic_model(checkpoint: str, device):
    """(model on `device`, config dict) from a `train/checkpoint.py` file and
    the `config.yml` beside it. A checkpoint that the trainer wrote also holds
    the training-only modules (and, for EFTS-CNN, weight norm as {v, g}):
    the model is built to take them, and an EFTS-CNN's weight norm is folded
    for inference as the weight bridge folds it. An EFTS-CNN's res-conv layers
    are built as the checkpoint holds them, {v, g} or plain (a converted
    folded reference file), whatever the config's `use_weight_norm`."""
    from efficient_tts_tpu_torch.models import model_class_for
    from efficient_tts_tpu_torch.models.efficient_tts import EftsCNN, EftsCNNConfig, config_for_state_dict
    from efficient_tts_tpu_torch.train.checkpoint import load_checkpoint
    from efficient_tts_tpu_torch.utils.config import load_config, model_config_from_dict
    from efficient_tts_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    config = load_config(os.path.join(os.path.dirname(os.path.abspath(checkpoint)), "config.yml"))
    cfg = model_config_from_dict(config)
    keys = torch.load(os.path.abspath(checkpoint), map_location="cpu", weights_only=True, mmap=True)["params"]
    training_modules = any(k.startswith("mel_encoder.") for k in keys)
    if training_modules and isinstance(cfg, EftsCNNConfig):
        cfg = config_for_state_dict(cfg, keys)
    model = model_class_for(cfg)(cfg, training_modules=training_modules).to(dev)
    load_checkpoint(checkpoint, {"params": model}, load_only_params=True)
    if isinstance(model, EftsCNN):
        model.fold_weight_norm()
    model.requires_grad_(False)
    return model.eval(), config


def load_vocoder(path: str | None, device):
    """The vocoder on `device` with the config beside `path`
    (`utils/config.py:vocoder_config_near_checkpoint`) or the HiFi-GAN V1
    defaults: from a `bin/train_vocoder.py` checkpoint, a reference HiFi-GAN
    generator file or a BigVGAN generator file, else seeded random weights."""
    from efficient_tts_tpu_torch import compat, init
    from efficient_tts_tpu_torch.utils.config import vocoder_config_near_checkpoint

    voc_cfg = vocoder_config_near_checkpoint(path)
    if path:
        return _load_vocoder(path, voc_cfg, device)
    logging.warning("no --vocoder_checkpoint: using random vocoder weights")
    return compat.hifigan_generator_from_jax(init.init_generator(1, voc_cfg), voc_cfg, device=device)


def _load_vocoder(path: str, voc_cfg, device):
    """A vocoder trainer's checkpoint ({"gen": {"params": sd, ...}, ...[,
    "ema": sd]}): the EMA generator when present, else the generator, folded
    for inference; or a reference generator file ({"generator": sd},
    {"model": sd} or a bare state dict, weight-normed or folded); a BigVGAN
    config reads the file as NVIDIA/BigVGAN's generator state dict."""
    from efficient_tts_tpu_torch import compat
    from efficient_tts_tpu_torch.compat import torch_import
    from efficient_tts_tpu_torch.models.bigvgan import BigVGANConfig
    from efficient_tts_tpu_torch.models.hifigan_train import HiFiGANTrainGenerator

    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path} is an orbax checkpoint directory of the JAX vocoder trainer, which the port does not read; "
            "pass a checkpoint of efficient_tts_tpu_torch.bin.train_vocoder or a reference generator file")
    if not os.path.isfile(path):
        raise ValueError(f"unsupported vocoder checkpoint: {path}")
    if isinstance(voc_cfg, BigVGANConfig):
        return compat.bigvgan_generator_from_state_dict(torch_import.load_reference_checkpoint(path)["model"],
                                                        voc_cfg, device=device)
    state = torch.load(os.path.abspath(path), map_location="cpu", weights_only=False)
    if isinstance(state, dict) and isinstance(state.get("gen"), dict) and "params" in state["gen"]:
        gen = HiFiGANTrainGenerator(voc_cfg)
        gen.load_state_dict(state["ema"] if "ema" in state else state["gen"]["params"])
        return gen.fold(device=device)
    return torch_import.hifigan_generator_from_state_dict(torch_import.load_reference_checkpoint(path)["model"],
                                                          voc_cfg, device=device)


def _write_wav(path: str, wav: np.ndarray, sr: int) -> None:
    from scipy.io.wavfile import write

    pcm = np.clip(wav, -1.0, 1.0)
    write(path, sr, (pcm * 32767).astype(np.int16))


def main(argv=None):
    args = get_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    from efficient_tts_tpu_torch import pipeline
    from efficient_tts_tpu_torch.data.dataset import load_filepaths_and_text
    from efficient_tts_tpu_torch.text import load_phone_vocab, phones_to_sequence, text_to_sequence
    from efficient_tts_tpu_torch.utils.device import resolve_device
    from efficient_tts_tpu_torch.utils.masks import pad_list

    device = resolve_device("cpu" if args.use_cpu else "cuda")
    timing = {"phases": {}, "batches": [], "passes": []}
    t_phase = time.time()
    model, config = load_acoustic_model(args.checkpoint, device)
    timing["phases"]["efts_load_s"] = round(time.time() - t_phase, 3)
    t_phase = time.time()
    voc = load_vocoder(args.vocoder_checkpoint, device)
    timing["phases"]["vocoder_load_s"] = round(time.time() - t_phase, 3)

    ds_params = dict(config.get("dataset_params", {}))
    use_phnseq = bool(ds_params.get("use_phnseq", False))
    phn2idx = load_phone_vocab(ds_params["phnset_path"]) if use_phnseq else None
    items = load_filepaths_and_text(args.test_fid_scp)[: args.num_utts]
    os.makedirs(args.outdir, exist_ok=True)
    correction = args.duration_correction_threshold if args.duration_correction else False

    sr = voc.cfg.sampling_rate
    first_audio = 0.0
    for rep in range(max(args.repeats, 1)):
        total_audio, total_time = 0.0, 0.0
        for lo in range(0, len(items), args.batch_size):
            chunk = items[lo: lo + args.batch_size]
            seqs = [np.asarray(phones_to_sequence(text, phn2idx) if use_phnseq else text_to_sequence(text), np.int32)
                    for _, text in chunk]
            text_ids = pad_list(seqs)
            lengths = np.asarray([len(s) for s in seqs], np.int32)
            t0 = time.time()
            wav, wav_lengths = pipeline.synthesize(model, voc, text_ids, lengths, duration_correction=correction,
                                                   device=device)
            dt = time.time() - t0
            total_time += dt
            timing["batches"].append({"pass": rep, "n": len(chunk), "t1": int(text_ids.shape[1]),
                                      "wall_s": round(dt, 3)})
            if rep:
                continue  # the wavs are the same in every pass; written once
            for i, (path, _) in enumerate(chunk):
                n = int(wav_lengths[i])
                total_audio += n / sr
                name = os.path.splitext(os.path.basename(path))[0]
                _write_wav(os.path.join(args.outdir, f"{name}_gen.wav"), wav[i, :n], sr)
            first_audio = total_audio
        total_audio = total_audio or first_audio
        rtf = total_time / max(total_audio, 1e-9)
        timing["passes"].append({"pass": rep, "audio_s": round(total_audio, 2), "wall_s": round(total_time, 2),
                                 "rtf": round(rtf, 4), "audio_s_per_s": round(1.0 / max(rtf, 1e-9), 1)})
        logging.info("pass %d: synthesized %.1f s of audio in %.2f s (RTF %.4f, %.1f audio-s/s)%s", rep,
                     total_audio, total_time, rtf, 1.0 / max(rtf, 1e-9),
                     "" if rep else " [includes the kernels' first build]")
    if args.timing_json:
        with open(args.timing_json, "w") as f:
            json.dump(timing, f, indent=1)


if __name__ == "__main__":
    main()
