"""Training CLI of the acoustic models (counterpart of `efficient_tts_tpu/bin/train.py`).

    python -m efficient_tts_tpu_torch.bin.train \\
        --config efficient_tts_tpu_torch/configs/lj_efts_cnn_char.yaml \\
        --train_fid_scp train.txt --dev_fid_scp dev.txt --outdir exp/lj \\
        [--resume CKPT | --pretrain CKPT] [--set KEY=VALUE ...] [--use_cpu]

    torchrun --nproc_per_node N -m efficient_tts_tpu_torch.bin.train ... [--mesh_model M]

Trains the model that `model_name` names (EFTS-CNN or EFTS-Transformer;
a DurationModel config raises, as the JAX package's CLI has no path for
it) on a `wavpath|text` filelist: `TextMelDataset` extracts the mels on the
host, a worker thread collates length-bucketed batches, `device_prefetch`
copies them to the card ahead of their step, and `EftsTrainer` runs the
steps with interval logs, evals (at most 8 dev batches; a dev set smaller
than a batch still gives one) and checkpoints. The merged config is dumped
to `outdir/config.yml`, from which `bin/inference.py` rebuilds the model.
Without `--resume` or `--pretrain` it resumes from the newest checkpoint
in the outdir, and it saves once more at the end, waiting for the write
(the interval saves write in the background). The weights start from
the seeded numpy init (`init.py`, `seed` in the config). Runs on the card
unless `--use_cpu` is given; without a card it raises.

Over ranks (JAX :32-37, :84-87, :117-174), one process per rank: under
torchrun's environment, or with `--coordinator` (host:port or a URL such
as file:///path), `--num_processes` and `--process_id`. NCCL joins the
cards (gloo with `--use_cpu`, or `--dist_backend gloo`; `--device_index`
puts every rank on one card on purpose). The model extent is `--mesh_model`
(else the config's `mesh.model`, else 1) and the data extent the config's
`mesh.data`, else `parallel/mesh.py:fit_data_extent(batch_size, world //
model)`. Every rank reads the same seeded loader over
the global batch and `device_prefetch(mesh=)` keeps its rows, as JAX
shards one global batch, so a first step over ranks is one card's; the
eval batch is a multiple of the data extent. Rank 0 alone writes the
config, the logs and the checkpoints (the one-card file).
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
    add_distributed_args(p)
    p.add_argument("--mesh_model", type=int, default=None, help="model-parallel extent (overrides mesh.model)")
    return p


def add_distributed_args(p) -> None:
    """The rendezvous options of the training CLIs (torchrun's environment
    needs none of them)."""
    p.add_argument("--coordinator", default=None,
                   help="rendezvous address host:port or a URL (file:///path); with --num_processes and "
                   "--process_id")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--dist_backend", default=None, choices=["nccl", "gloo"],
                   help="process-group backend (default: nccl on the card, gloo with --use_cpu)")
    p.add_argument("--device_index", type=int, default=None,
                   help="this rank's card (default: LOCAL_RANK); the same index on every rank shares one card")


def join_ranks(args, device: str):
    """Join the process group when the arguments or torchrun's environment
    ask for ranks; returns (world size, this rank's device)."""
    import os

    import torch.distributed as dist

    from efficient_tts_tpu_torch.parallel.distributed import initialize_multihost, rank_device

    if args.coordinator is not None:
        initialize_multihost(args.coordinator, args.num_processes, args.process_id, backend=args.dist_backend,
                             device=device)
    elif "WORLD_SIZE" in os.environ:
        initialize_multihost(backend=args.dist_backend, device=device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    return world, rank_device(device, index=args.device_index)


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


def train_mesh(world: int, batch_size: int, model: int = 1, data: int | None = None):
    """The [data, model] mesh of a training run, or None for one card: the
    data extent is `data`, else the largest divisor of the batch that the
    ranks left by `model` allow. Every rank must be in it."""
    from efficient_tts_tpu_torch.parallel import fit_data_extent, make_mesh

    if world == 1 and model == 1 and int(data or 1) == 1:
        return None
    if int(data or 1) * model > world:
        raise ValueError(f"a mesh of {data or 1} x {model} needs {int(data or 1) * model} ranks and this run has "
                         f"{world}: launch one process a rank (torchrun, or --coordinator / --num_processes / "
                         "--process_id)")
    if world % model:
        raise ValueError(f"{world} ranks not divisible by the model extent {model}")
    mesh = make_mesh(int(data or fit_data_extent(batch_size, world // model)), model)
    if not mesh.member:
        raise ValueError(f"rank {mesh.rank} is outside the mesh {mesh.shape}: a batch of {batch_size} over "
                         f"{world} ranks leaves it idle; give mesh.data * model = {world}")
    return mesh


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
    from efficient_tts_tpu_torch.parallel import is_primary
    from efficient_tts_tpu_torch.utils.config import dump_config, load_config, model_config_from_dict

    world, device = join_ranks(args, "cpu" if args.use_cpu else "cuda")
    config = apply_overrides(load_config(args.config), args.overrides)
    cfg = model_config_from_dict(config)
    if isinstance(cfg, DurationModelConfig):
        raise NotImplementedError("bin.train trains EFTS-CNN and EFTS-Transformer; the DurationModel has no "
                                  "training CLI (nor in the JAX package): train it with "
                                  "train/duration_train_step.py on data/collate.py:collate_duration_model batches")
    if is_primary():
        dump_config(config, args.outdir)
    tx = optimizer_from_dict(config)

    ds_params = dict(config.get("dataset_params", {}))
    train_ds = TextMelDataset(args.train_fid_scp, **ds_params)
    batch_size = int(config.get("batch_size", 32))
    mesh_cfg = dict(config.get("mesh") or {})
    mesh = train_mesh(world, batch_size, int(args.mesh_model or mesh_cfg.get("model") or 1), mesh_cfg.get("data"))
    text_bucket = int(config.get("text_bucket", 16))
    mel_bucket = int(config.get("mel_bucket", 64))

    def collate(batch):
        return collate_text_mel(batch, text_bucket, mel_bucket)

    # background_prefetch collates the next batch on a worker thread across
    # epochs; device_prefetch then copies it to the card ahead of its step.
    # Both keep the identity of a repeated whole-corpus batch.
    length_fn = train_ds.approx_length if config.get("length_bucketing", True) else None
    accum_steps = int(config.get("accum_steps", 1))
    train_iter = device_prefetch(background_prefetch(infinite_loader(train_ds, batch_size, collate,
                                                                     length_fn=length_fn)),
                                 size=2, device=device, dtypes=BATCH_DTYPES, mesh=mesh, accum_steps=accum_steps)

    eval_batches = []
    if args.dev_fid_scp:
        dev_ds = TextMelDataset(args.dev_fid_scp, **ds_params)
        # a dev set smaller than the train batch still gives one eval batch,
        # a multiple of the data extent
        de = mesh.shape["data"] if mesh is not None else 1
        eval_bs = min(batch_size, max(len(dev_ds), 1))
        eval_bs = max(eval_bs // de * de, de)
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
        accum_steps=accum_steps, device=device, mesh=mesh,
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
    trainer.save(wait=True)
    return trainer


if __name__ == "__main__":
    main()
