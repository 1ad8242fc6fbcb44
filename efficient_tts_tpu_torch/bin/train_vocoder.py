"""HiFi-GAN vocoder training CLI (counterpart of `efficient_tts_tpu/bin/train_vocoder.py`).

    python -m efficient_tts_tpu_torch.bin.train_vocoder \\
        --wav_scp wavs.txt --outdir exp_vocoder [--config hifigan.yaml] [--use_cpu]

`--wav_scp` holds one wav path per line (or `path|text` lines, the text
ignored). The config's `vocoder_params` give the generator
(`HiFiGANConfig`, V1 by default) and `learning_rate`, `adam_betas` and
`lr_decay` the optimizer (HiFi-GAN's 2e-4, (0.8, 0.99), 0.999 an epoch);
the config is dumped to `outdir/config.yml`, from which the inference and
serving CLIs rebuild the generator. `MelAudioSegmentDataset` crops the
segments and takes their mels on the host, a worker thread collates the
next batches, `device_prefetch` copies them to the card ahead of their
step, and `HiFiGANTrainer` runs the GAN steps with interval logs, evals
(the first 4 x batch_size dev segments) and checkpoints. Without
`--resume` it resumes from the newest checkpoint in the outdir, and it
saves at the end unless it has just saved that step. The weights start
from the seeded numpy init (`init.py`, seed 0). Runs on the card unless
`--use_cpu` is given; without a card it raises.

The corpus held on the device (`--device_corpus on`) is not ported:
`auto` takes the host data path, and `on` raises.
"""

from __future__ import annotations

import argparse
import logging


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
                   help="hold the wav corpus on the card (not ported: auto takes the host path, on raises)")
    p.add_argument("--use_cpu", action="store_true", help="run on the CPU (the default is the card)")
    return p


def _read_scp(path: str) -> list:
    with open(path) as f:
        return [line.strip().split("|")[0] for line in f if line.strip()]


def main(argv=None):
    """Train as the arguments say; returns the `HiFiGANTrainer` after its final save."""
    args = get_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    if args.device_corpus == "on":
        raise NotImplementedError("--device_corpus on: the device-resident corpus (data/device_corpus.py) is not "
                                  "ported yet (ROADMAP Queue 1 item 8b); use --device_corpus off")
    import torch

    from efficient_tts_tpu_torch.data.collate import collate_mel_audio
    from efficient_tts_tpu_torch.data.dataset import MelAudioSegmentDataset
    from efficient_tts_tpu_torch.data.loader import background_prefetch, device_prefetch, infinite_loader
    from efficient_tts_tpu_torch.train import checkpoint as ckpt
    from efficient_tts_tpu_torch.train.hifigan_train_step import (BATCH_KEYS, init_gan_state, make_gan_eval_step,
                                                                  make_gan_train_step)
    from efficient_tts_tpu_torch.train.hifigan_trainer import HiFiGANTrainer
    from efficient_tts_tpu_torch.train.optim import HiFiGANAdam
    from efficient_tts_tpu_torch.utils.config import dump_config, load_config, vocoder_config_from_dict
    from efficient_tts_tpu_torch.utils.device import resolve_device

    device = resolve_device("cpu" if args.use_cpu else "cuda")
    config = load_config(args.config) if args.config else {}
    voc_cfg = vocoder_config_from_dict(config)
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
    state = init_gan_state(0, voc_cfg, gen_tx, disc_tx, ema_decay=args.ema_decay, device=device)
    step = make_gan_train_step(voc_cfg, gen_tx, disc_tx, use_stft_loss=args.use_stft_loss, ema_decay=args.ema_decay,
                               compute_dtype=torch.bfloat16 if args.compute_dtype == "bfloat16" else None,
                               device=device)
    # background_prefetch crops and collates the next batches on a worker
    # thread across epochs; device_prefetch copies them to the card ahead
    train_iter = device_prefetch(background_prefetch(infinite_loader(ds, args.batch_size, collate_mel_audio)),
                                 size=2, device=device, dtypes={k: torch.float32 for k in BATCH_KEYS})
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
                             max_keep_checkpoints=args.max_keep_checkpoints, device=device)
    resume = args.resume or ckpt.latest_checkpoint(args.outdir)
    if resume:
        logging.info("resuming from %s", resume)
        trainer.load(resume)
    trainer.run()
    if trainer.saved_step != trainer.state["step"]:
        trainer.save()
    return trainer


if __name__ == "__main__":
    main()
