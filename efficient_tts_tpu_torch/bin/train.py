"""Training CLI of the acoustic models (counterpart of `efficient_tts_tpu/bin/train.py`).

    python -m efficient_tts_tpu_torch.bin.train \\
        --config efficient_tts_tpu_torch/configs/lj_efts_cnn_char.yaml \\
        --train_fid_scp train.txt --dev_fid_scp dev.txt --outdir exp/lj \\
        [--resume CKPT | --pretrain CKPT] [--set KEY=VALUE ...] [--use_cpu]

Trains the model that `model_name` names (EFTS-CNN or EFTS-Transformer;
a DurationModel config raises, as the JAX package's CLI has no path for
it) on a `wavpath|text` filelist: `TextMelDataset` extracts the mels on the
host, a worker thread collates length-bucketed batches, `device_prefetch`
copies them to the card ahead of their step, and `EftsTrainer` runs the
steps with interval logs, evals (at most 8 dev batches; a dev set smaller
than a batch still gives one) and checkpoints. The merged config is dumped
to `outdir/config.yml`, from which `bin/inference.py` rebuilds the model.
Without `--resume` or `--pretrain` it resumes from the newest checkpoint
in the outdir, and it saves once more at the end. The weights start from
the seeded numpy init (`init.py`, `seed` in the config). Runs on the card
unless `--use_cpu` is given; without a card it raises. One card only: a
config whose `mesh` asks for more devices raises (multi-GPU training is
not ported).
"""

from __future__ import annotations

import argparse
import logging


def get_parser():
    p = argparse.ArgumentParser(description="Train EFTS-CNN or EFTS-Transformer on the card")
    p.add_argument("--config", required=True, help="YAML (or JSON) config file")
    p.add_argument("--train_fid_scp", required=True, help="train filelist (wavpath|text)")
    p.add_argument("--dev_fid_scp", default=None, help="dev filelist")
    p.add_argument("--outdir", required=True, help="output directory")
    p.add_argument("--resume", default=None, help="checkpoint to resume (full state)")
    p.add_argument("--pretrain", default=None, help="checkpoint to warm-start (params only)")
    p.add_argument("--verbose", type=int, default=1)
    p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE", dest="overrides",
                   help="override a config key, dotted for a nested one (a.b.c); the value is read as "
                   "YAML; repeatable")
    p.add_argument("--use_cpu", action="store_true", help="run on the CPU (the default is the card)")
    return p


def apply_overrides(config: dict, overrides: list) -> dict:
    """KEY=VALUE overrides; KEY may be dotted (a.b.c) to set a nested key,
    e.g. --set model_params.loss_normalize=utterance."""
    import yaml

    for item in overrides:
        key, sep, value = item.partition("=")
        parts = key.split(".")
        if not sep or not all(parts):
            raise SystemExit(f"--set expects KEY=VALUE, got {item!r}")
        node = config
        for p in parts[:-1]:
            node = node.setdefault(p, {})
            if not isinstance(node, dict):
                raise SystemExit(f"--set {item!r}: {p!r} is not a mapping in the config")
        node[parts[-1]] = yaml.safe_load(value)
    return config


def _check_one_device(config: dict) -> None:
    mesh = dict(config.get("mesh") or {})
    if int(mesh.get("data") or 1) != 1 or int(mesh.get("model") or 1) != 1:
        raise NotImplementedError(f"mesh {mesh} asks for more than one device; the port trains on one card "
                                  "(multi-GPU training is ROADMAP Queue 1 item 11b)")


def build_model(cfg, seed: int, device):
    """The trainable model of `cfg` from the seeded numpy init."""
    from efficient_tts_tpu_torch import compat, init
    from efficient_tts_tpu_torch.models.efficient_tts import EftsCNNConfig

    if isinstance(cfg, EftsCNNConfig):
        return compat.efts_cnn_from_jax(init.init_efts(seed, cfg), cfg, device=device, trainable=True)
    return compat.efts_transformer_from_jax(init.init_efts_transformer(seed, cfg), cfg, device=device,
                                            trainable=True)


def main(argv=None):
    """Train as the arguments say; returns the `EftsTrainer` after its final save."""
    args = get_parser().parse_args(argv)
    logging.basicConfig(level=logging.DEBUG if args.verbose > 1 else logging.INFO,
                        format="%(asctime)s (%(module)s:%(lineno)d) %(levelname)s: %(message)s")
    from efficient_tts_tpu_torch.data.collate import collate_text_mel
    from efficient_tts_tpu_torch.data.dataset import TextMelDataset
    from efficient_tts_tpu_torch.data.loader import background_prefetch, data_loader, device_prefetch, infinite_loader
    from efficient_tts_tpu_torch.models.duration_model import DurationModelConfig
    from efficient_tts_tpu_torch.train import checkpoint as ckpt
    from efficient_tts_tpu_torch.train.efts_train_step import BATCH_DTYPES
    from efficient_tts_tpu_torch.train.efts_trainer import EftsTrainer
    from efficient_tts_tpu_torch.train.optim import optimizer_from_dict
    from efficient_tts_tpu_torch.utils.config import dump_config, load_config, model_config_from_dict
    from efficient_tts_tpu_torch.utils.device import resolve_device

    device = resolve_device("cpu" if args.use_cpu else "cuda")
    config = apply_overrides(load_config(args.config), args.overrides)
    _check_one_device(config)
    cfg = model_config_from_dict(config)
    if isinstance(cfg, DurationModelConfig):
        raise NotImplementedError("bin.train trains EFTS-CNN and EFTS-Transformer; the DurationModel has no "
                                  "training CLI (nor in the JAX package): train it with "
                                  "train/duration_train_step.py on data/collate.py:collate_duration_model batches")
    dump_config(config, args.outdir)
    tx = optimizer_from_dict(config)

    ds_params = dict(config.get("dataset_params", {}))
    train_ds = TextMelDataset(args.train_fid_scp, **ds_params)
    batch_size = int(config.get("batch_size", 32))
    text_bucket = int(config.get("text_bucket", 16))
    mel_bucket = int(config.get("mel_bucket", 64))

    def collate(batch):
        return collate_text_mel(batch, text_bucket, mel_bucket)

    # background_prefetch collates the next batch on a worker thread across
    # epochs; device_prefetch then copies it to the card ahead of its step.
    # Both keep the identity of a repeated whole-corpus batch.
    length_fn = train_ds.approx_length if config.get("length_bucketing", True) else None
    train_iter = device_prefetch(background_prefetch(infinite_loader(train_ds, batch_size, collate,
                                                                     length_fn=length_fn)),
                                 size=2, device=device, dtypes=BATCH_DTYPES)

    eval_batches = []
    if args.dev_fid_scp:
        dev_ds = TextMelDataset(args.dev_fid_scp, **ds_params)
        # a dev set smaller than the train batch still gives one eval batch
        eval_bs = min(batch_size, max(len(dev_ds), 1))
        eval_batches = list(data_loader(dev_ds, eval_bs, collate, shuffle=False))[:8]
        if not eval_batches:
            logging.warning("dev set (%d utts) yields no eval batch at batch size %d", len(dev_ds), eval_bs)

    trainer = EftsTrainer(
        cfg, tx, train_iter, eval_batches=eval_batches, outdir=args.outdir,
        train_max_steps=int(config.get("train_max_steps", 1_000_000)),
        save_interval_steps=int(config.get("save_interval_steps", 5000)),
        eval_interval_steps=int(config.get("eval_interval_steps", 1000)),
        log_interval_steps=int(config.get("log_interval_steps", 1000)),
        max_keep_checkpoints=config.get("max_keep_checkpoints"),
        accum_steps=int(config.get("accum_steps", 1)), device=device,
    )
    trainer.init_state(build_model(cfg, int(config.get("seed", 0)), device))
    if args.resume:
        trainer.load(args.resume, load_only_params=False)
    elif args.pretrain:
        trainer.load(args.pretrain, load_only_params=True)
    else:
        latest = ckpt.latest_checkpoint(args.outdir)
        if latest:
            logging.info("auto-resuming from %s", latest)
            trainer.load(latest, load_only_params=False)
    trainer.run()
    trainer.save()
    return trainer


if __name__ == "__main__":
    main()
