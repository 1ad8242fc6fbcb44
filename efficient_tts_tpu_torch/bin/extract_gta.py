"""Ground-truth-aligned (GTA) mels for vocoder fine-tuning (counterpart of `efficient_tts_tpu/bin/extract_gta.py`).

    python -m efficient_tts_tpu_torch.bin.extract_gta \\
        --fid_scp data/train.txt --checkpoint exp/lj/checkpoint-...steps --outdir gta_mels/ [--use_cpu]

Runs the training forward of a trained EFTS-CNN checkpoint (the
`config.yml` beside it; the alignment teacher-forced from the ground-truth
mel, so the frames match the audio's) over a `wavpath|text` filelist in
its order, and writes each utterance's predicted mel as `<utt>.npy`,
[n_mels, T2] f32 trimmed to its length: the layout that
`MelAudioSegmentDataset(fine_tuning=True)` reads. The checkpoint is the
one `bin/train.py` writes, weight norm kept as {v, g} and computed in f32
at each forward as the JAX package does. Runs on the card unless
`--use_cpu` is given; without a card it raises.
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np


def get_parser():
    p = argparse.ArgumentParser(description="GTA mel extraction")
    p.add_argument("--fid_scp", required=True)
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--outdir", required=True)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--use_cpu", action="store_true", help="run on the CPU (the default is the card)")
    return p


def main(argv=None) -> int:
    """Extract as the arguments say; returns the number of mels written."""
    args = get_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    from efficient_tts_tpu_torch.data.collate import collate_text_mel
    from efficient_tts_tpu_torch.data.dataset import TextMelDataset
    from efficient_tts_tpu_torch.data.loader import data_loader
    from efficient_tts_tpu_torch.models import model_class_for
    from efficient_tts_tpu_torch.models.efficient_tts import EftsCNN
    from efficient_tts_tpu_torch.train.checkpoint import load_checkpoint
    from efficient_tts_tpu_torch.train.efts_train_step import make_eval_step
    from efficient_tts_tpu_torch.utils.config import load_config, model_config_from_dict
    from efficient_tts_tpu_torch.utils.device import resolve_device

    device = resolve_device("cpu" if args.use_cpu else "cuda")
    config = load_config(os.path.join(os.path.dirname(os.path.abspath(args.checkpoint)), "config.yml"))
    cfg = model_config_from_dict(config)
    model_cls = model_class_for(cfg, training=True)
    if model_cls is not EftsCNN:
        raise NotImplementedError(f"GTA extraction takes an EFTS-CNN checkpoint, not {model_cls.__name__}")
    model = model_cls(cfg, training_modules=True).to(device)
    load_checkpoint(args.checkpoint, {"params": model}, load_only_params=True)
    model.requires_grad_(False)
    eval_step = make_eval_step(cfg, device=device)

    ds = TextMelDataset(args.fid_scp, **dict(config.get("dataset_params", {})))
    os.makedirs(args.outdir, exist_ok=True)
    ids = [os.path.splitext(os.path.basename(item[0]))[0] for item in ds.items]

    def collate(items):
        # in the filelist's order: rows map back to utterance ids
        return collate_text_mel(items, sort=False)

    n_done = 0
    for batch in data_loader(ds, args.batch_size, collate, shuffle=False, drop_last=False):
        mel_pred = eval_step(model, batch)["mel_pred"].float().cpu().numpy()
        for i in range(mel_pred.shape[0]):
            t2 = int(batch["mel_lengths"][i])
            np.save(os.path.join(args.outdir, ids[n_done] + ".npy"), mel_pred[i, :t2].T.astype(np.float32))
            n_done += 1
        if n_done % 200 < args.batch_size:
            logging.info("extracted %d/%d", n_done, len(ds))
    logging.info("done: %d GTA mels -> %s", n_done, args.outdir)
    return n_done


if __name__ == "__main__":
    main()
