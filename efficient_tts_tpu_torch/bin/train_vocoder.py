"""HiFi-GAN vocoder training CLI (counterpart of `efficient_tts_tpu/bin/train_vocoder.py`).

    python -m efficient_tts_tpu_torch.bin.train_vocoder \\
        --wav_scp wavs.txt --outdir exp_vocoder [--config hifigan.yaml] [--use_cpu]

`--wav_scp` holds one wav path per line (or `path|text` lines, the text
ignored). The config's `vocoder_params` give the generator
(`HiFiGANConfig`, V1 by default) and `learning_rate`, `adam_betas` and
`lr_decay` the optimizer (HiFi-GAN's 2e-4, (0.8, 0.99), 0.999 an epoch);
the config is dumped to `outdir/config.yml`, from which the inference and
serving CLIs rebuild the generator. Two data paths:
  * the device path (`--device_corpus on`, `data/device_corpus.py`): the
    whole wav corpus is uploaded once, and each step crops its segments and
    takes both mels on the card from a stream that is a function of the
    step (a resume continues it); the iterator repeats (0, corpus), so the
    logged data wait is the time to fetch that pair;
  * the host path (`off`): `MelAudioSegmentDataset` crops the segments and
    takes their mels on the host, a worker thread collates the next
    batches, and `device_prefetch` copies them to the card ahead of their
    step.
`auto` (the default) takes the device path when not fine-tuning and the
padded corpus (`corpus_nbytes`) fits 2 GiB, the JAX package's budget;
LJSpeech pads to about 11.7 GB and stays on the host path. GTA fine-tuning
reads the stored mels, so `--device_corpus on` with `--fine_tuning` raises.
`HiFiGANTrainer` runs the GAN steps with interval logs, evals (the first
4 x batch_size dev segments) and checkpoints. Without `--resume` it
resumes from the newest checkpoint in the outdir, and it saves at the end
unless it has just saved that step; the interval saves write in the
background, and `main` returns once every write is on disk. The weights start from the seeded
numpy init (`init.py`, seed 0). Runs on the card unless `--use_cpu` is
given; without a card it raises. `main` returns the trainer, whose
`data_path` says which path ran.

Over ranks (JAX :120-163; torchrun, or `--coordinator` / `--num_processes`
/ `--process_id`, as `bin/train.py` takes them): the host path on a
data-parallel mesh of model extent 1 (`fit_data_extent(batch_size,
world)`), every rank reading the same seeded loader and keeping its rows of
each global batch (`device_prefetch(mesh=)`). The device corpus crops one
batch per card from a stream of the step, so `auto` takes the host path in
a world larger than one and `on` there raises. Rank 0 alone writes the
config, the logs, the checkpoints and runs the evals.
"""

from __future__ import annotations

import argparse
import itertools
import logging

from efficient_tts_tpu_torch.bin.train import add_distributed_args, join_ranks, train_mesh

DEVICE_CORPUS_BUDGET = 2 << 30  # bytes of the padded corpus `auto` puts on the card


def get_parser():
    p = argparse.ArgumentParser(description="Train the HiFi-GAN vocoder on the card")
    p.add_argument("--wav_scp", required=True)
    p.add_argument("--dev_wav_scp", default=None, help="validation wav list")
    p.add_argument("--outdir", required=True)
    p.add_argument("--config", default=None, help="optional YAML overriding defaults")
    p.add_argument("--resume", default=None)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--train_max_steps", type=int, default=400000)
    p.add_argument("--save_interval_steps", type=int, default=5000)
    p.add_argument("--eval_interval_steps", type=int, default=1000)
    p.add_argument("--log_interval_steps", type=int, default=100)
    p.add_argument("--use_stft_loss", action="store_true")
    p.add_argument("--compute_dtype", default=None, choices=["bfloat16"],
                   help="bf16 conv towers (params/losses stay f32)")
    p.add_argument("--max_keep_checkpoints", type=int, default=None,
                   help="retain only the newest N checkpoints (default: all)")
    p.add_argument("--ema_decay", type=float, default=None,
                   help="track an EMA of generator weights for eval/serving")
    p.add_argument("--lr_decay_steps", type=int, default=None,
                   help="steps per lr_decay application (default: one epoch, the official HiFi-GAN semantics; "
                   "on a tiny corpus one-batch epochs decay 0.999 a step, so set ~800-1000 there)")
    p.add_argument("--fine_tuning", action="store_true",
                   help="GTA fine-tuning: generator input from --base_mels_path")
    p.add_argument("--base_mels_path", default=None,
                   help="dir of GTA mels from efficient_tts_tpu_torch.bin.extract_gta")
    p.add_argument("--device_corpus", choices=["auto", "on", "off"], default="auto",
                   help="hold the wav corpus on the card and crop and take mels there (auto: when not "
                   "fine-tuning and the padded corpus fits 2 GiB)")
    p.add_argument("--use_cpu", action="store_true", help="run on the CPU (the default is the card)")
    add_distributed_args(p)
    return p


def _read_scp(path: str) -> list:
    with open(path) as f:
        return [line.strip().split("|")[0] for line in f if line.strip()]


def main(argv=None):
    """Train as the arguments say; returns the `HiFiGANTrainer` after its final save."""
    args = get_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    if args.device_corpus == "on" and args.fine_tuning:
        raise ValueError("--device_corpus on with --fine_tuning: GTA fine-tuning trains on the GTA mels of "
                         "--base_mels_path, which the device corpus does not hold (it would recompute mels from "
                         "the audio); use --device_corpus off or auto")
    import torch

    from efficient_tts_tpu_torch.data import device_corpus as dc
    from efficient_tts_tpu_torch.data.collate import collate_mel_audio
    from efficient_tts_tpu_torch.data.dataset import MelAudioSegmentDataset
    from efficient_tts_tpu_torch.data.loader import background_prefetch, device_prefetch, infinite_loader
    from efficient_tts_tpu_torch.train import checkpoint as ckpt
    from efficient_tts_tpu_torch.parallel import is_primary
    from efficient_tts_tpu_torch.train.hifigan_train_step import (BATCH_KEYS, init_gan_state, make_gan_eval_step,
                                                                  make_gan_train_step, shard_gan_state)
    from efficient_tts_tpu_torch.train.hifigan_trainer import HiFiGANTrainer
    from efficient_tts_tpu_torch.train.optim import HiFiGANAdam
    from efficient_tts_tpu_torch.utils.config import dump_config, load_config, vocoder_config_from_dict

    world, device = join_ranks(args, "cpu" if args.use_cpu else "cuda")
    if args.device_corpus == "on" and world > 1:
        raise ValueError(f"--device_corpus on in a world of {world} ranks: the device corpus crops one batch "
                         "per card from a stream of the step, not a rank's rows of a global batch; use "
                         "--device_corpus off or auto (the host path)")
    mesh = train_mesh(world, args.batch_size)
    config = load_config(args.config) if args.config else {}
    voc_cfg = vocoder_config_from_dict(config)
    if config.get("vocoder_name", "HiFiGAN") != "HiFiGAN":
        raise ValueError(f"bin.train_vocoder trains HiFi-GAN generators, not vocoder_name={config['vocoder_name']!r}")
    if is_primary():
        dump_config(config, args.outdir)
    lr = float(config.get("learning_rate", 2e-4))
    betas = tuple(config.get("adam_betas", (0.8, 0.99)))
    lr_decay = float(config.get("lr_decay", 0.999))

    files = _read_scp(args.wav_scp)
    ds = MelAudioSegmentDataset(files, segment_size=voc_cfg.segment_size, fine_tuning=args.fine_tuning,
                                base_mels_path=args.base_mels_path)
    steps_per_epoch = args.lr_decay_steps or max(len(ds) // args.batch_size, 1)
    gen_tx = HiFiGANAdam(lr, betas, lr_decay, steps_per_epoch)
    disc_tx = HiFiGANAdam(lr, betas, lr_decay, steps_per_epoch)
    state = (init_gan_state(0, voc_cfg, gen_tx, disc_tx, ema_decay=args.ema_decay, device=device) if mesh is None
             else shard_gan_state(0, voc_cfg, gen_tx, disc_tx, mesh, ema_decay=args.ema_decay, device=device))
    step = make_gan_train_step(voc_cfg, gen_tx, disc_tx, use_stft_loss=args.use_stft_loss, ema_decay=args.ema_decay,
                               compute_dtype=torch.bfloat16 if args.compute_dtype == "bfloat16" else None,
                               device=device, mesh=mesh)
    on_device = args.device_corpus == "on" or (
        args.device_corpus == "auto" and not args.fine_tuning and world == 1
        and dc.corpus_nbytes(files, voc_cfg.segment_size) <= DEVICE_CORPUS_BUDGET)
    if on_device:
        corpus = dc.load_corpus(files, segment_size=voc_cfg.segment_size, device=device)
        step = dc.make_device_gan_train_step(step, dc.make_device_batch_fn(
            args.batch_size, segment_size=voc_cfg.segment_size, device=device))
        train_iter = itertools.repeat((0, corpus))
    else:
        # background_prefetch crops and collates the next batches on a worker
        # thread across epochs; device_prefetch copies them to the card ahead
        train_iter = device_prefetch(background_prefetch(infinite_loader(ds, args.batch_size, collate_mel_audio)),
                                     size=2, device=device, dtypes={k: torch.float32 for k in BATCH_KEYS},
                                     mesh=mesh)
    logging.info("vocoder data path: %s", "device corpus" if on_device else "host")
    eval_step, eval_batches = None, []
    if args.dev_wav_scp:
        dev_ds = MelAudioSegmentDataset(_read_scp(args.dev_wav_scp), segment_size=voc_cfg.segment_size,
                                        shuffle=False, fine_tuning=args.fine_tuning,
                                        base_mels_path=args.base_mels_path)
        eval_batches = [collate_mel_audio([dev_ds[i] for i in range(lo, min(lo + args.batch_size, len(dev_ds)))])
                        for lo in range(0, min(len(dev_ds), 4 * args.batch_size), args.batch_size)]
        eval_step = make_gan_eval_step(voc_cfg, device=device)

    trainer = HiFiGANTrainer(step, state, train_iter, outdir=args.outdir, train_max_steps=args.train_max_steps,
                             save_interval_steps=args.save_interval_steps,
                             log_interval_steps=args.log_interval_steps, eval_step=eval_step,
                             eval_batches=eval_batches, eval_interval_steps=args.eval_interval_steps,
                             max_keep_checkpoints=args.max_keep_checkpoints, device=device, mesh=mesh)
    trainer.data_path = "device" if on_device else "host"
    resume = args.resume or ckpt.latest_checkpoint(args.outdir)
    if resume:
        logging.info("resuming from %s", resume)
        trainer.load(resume)
    trainer.run()
    if trainer.saved_step != trainer.state["step"]:
        trainer.save(wait=True)
    ckpt.wait_for_saves()
    return trainer


if __name__ == "__main__":
    main()
