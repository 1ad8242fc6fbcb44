"""Export the port's checkpoints to the reference's and the official HiFi-GAN's PyTorch files.

    # EFTS-CNN -> the reference trainer's .pkl, {"model", "steps", "epochs"}
    python -m efficient_tts_tpu_torch.bin.export_torch \\
        --model EfficientTTSCNN --checkpoint exp/lj/checkpoint-100000steps \\
        --out exp/lj/checkpoint-100000steps.pkl [--fold_weight_norm]

    # vocoder generator -> a `generator_v1` file, {"generator": sd}
    python -m efficient_tts_tpu_torch.bin.export_torch \\
        --model HiFiGANGenerator --checkpoint exp_voc/checkpoint-50000steps \\
        --out HiFiGAN_LJ_V1/generator_v1 [--ema] [--fold_weight_norm]

    # the whole GAN state -> the official recipe's g_/do_ pair (weights only)
    python -m efficient_tts_tpu_torch.bin.export_torch \\
        --model HiFiGANFull --checkpoint exp_voc/checkpoint-50000steps \\
        --out exp_voc/torch_export

Counterpart of `efficient_tts_tpu/bin/export_torch.py` (the inverse of
`convert_checkpoint.py`), through `compat/torch_export.py`. Reads a
`train/checkpoint.py` file: an acoustic trainer's {params, opt_state,
step} (EFTS-CNN, its res-conv layers weight-normed or plain as saved) or a
vocoder trainer's {gen, disc, step[, ema]}. `--ema` takes the EMA
generator when the checkpoint has one, else the generator.
`--fold_weight_norm` writes plain `.weight` keys, folded in f64 as the
weight bridge folds. HiFiGANFull writes `g_{step:08d}` ({"generator"}) and
`do_{step:08d}` ({"mpd", "msd", "steps", "epoch"}) into the `--out`
directory. The config comes from `--config`, else the `config.yml` beside
the checkpoint, else the library defaults. Export is host work and runs on
the CPU; it needs no card and touches none.
"""

from __future__ import annotations

import argparse
import logging
import os


def get_parser():
    p = argparse.ArgumentParser(description="Export checkpoints to torch files")
    p.add_argument("--checkpoint", required=True, help="a train/checkpoint.py checkpoint file")
    p.add_argument("--model", default="EfficientTTSCNN", choices=["EfficientTTSCNN", "HiFiGANGenerator", "HiFiGANFull"])
    p.add_argument("--out", required=True, help="output file (or directory for HiFiGANFull)")
    p.add_argument("--config", default=None,
                   help="YAML with model/vocoder params (default: config.yml next to the checkpoint, else library "
                   "defaults)")
    p.add_argument("--ema", action="store_true", help="export the EMA generator copy when tracked")
    p.add_argument("--fold_weight_norm", action="store_true",
                   help="export folded '.weight' keys (post remove_weight_norm) instead of weight_v/weight_g")
    return p


def _to_torch(sd: dict) -> dict:
    import torch

    return {k: torch.from_numpy(v) for k, v in sd.items()}


def _config(args) -> dict:
    from efficient_tts_tpu_torch.utils.config import load_config

    path = args.config or os.path.join(os.path.dirname(os.path.abspath(args.checkpoint)), "config.yml")
    return load_config(path) if os.path.exists(path) else {}


def main(argv=None) -> list:
    """Export as the arguments say; returns the written paths."""
    args = get_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    import torch

    from efficient_tts_tpu_torch.compat import torch_export
    from efficient_tts_tpu_torch.train.checkpoint import read_checkpoint

    saved = read_checkpoint(args.checkpoint, device="cpu")
    step = int(saved.get("step", 0))
    config = _config(args)

    if args.model == "EfficientTTSCNN":
        from efficient_tts_tpu_torch.models.efficient_tts import EftsCNN, EftsCNNConfig, config_for_state_dict
        from efficient_tts_tpu_torch.utils.config import model_config_from_dict

        cfg = model_config_from_dict(config)
        if not isinstance(cfg, EftsCNNConfig):
            raise ValueError(f"--model EfficientTTSCNN, but the config describes {config.get('model_name')}")
        sd = saved["params"]
        model = EftsCNN(config_for_state_dict(cfg, sd), training_modules=True)
        model.load_state_dict(sd)
        out = torch_export.efts_cnn_to_state_dict(model, fold=args.fold_weight_norm)
        # the reference trainer's checkpoint dict
        torch.save({"model": _to_torch(out), "steps": step, "epochs": 0}, args.out)
        logging.info("wrote %s (%d tensors, step %d)", args.out, len(out), step)
        return [args.out]

    from efficient_tts_tpu_torch.models.hifigan_train import Discriminators, HiFiGANTrainGenerator
    from efficient_tts_tpu_torch.utils.config import vocoder_config_from_dict

    if args.ema and "ema" not in saved:
        logging.warning("--ema: %s tracks no EMA generator; exporting the generator", args.checkpoint)
    gen = HiFiGANTrainGenerator(vocoder_config_from_dict(config))
    gen.load_state_dict(saved["ema"] if args.ema and "ema" in saved else saved["gen"]["params"])
    if args.model == "HiFiGANGenerator":
        out = torch_export.hifigan_generator_to_state_dict(gen, fold=args.fold_weight_norm)
        torch.save({"generator": _to_torch(out)}, args.out)
        logging.info("wrote %s (%d tensors)", args.out, len(out))
        return [args.out]

    disc = Discriminators()
    disc.load_state_dict(saved["disc"]["params"])
    g, do = torch_export.gan_state_to_torch_checkpoints({"gen": {"params": gen}, "disc": {"params": disc},
                                                         "step": step}, fold=args.fold_weight_norm)
    os.makedirs(args.out, exist_ok=True)
    g_path, do_path = os.path.join(args.out, f"g_{step:08d}"), os.path.join(args.out, f"do_{step:08d}")
    torch.save({"generator": _to_torch(g["generator"])}, g_path)
    torch.save({"mpd": _to_torch(do["mpd"]), "msd": _to_torch(do["msd"]), "steps": do["steps"],
                "epoch": do["epoch"]}, do_path)
    logging.info("wrote %s and %s", g_path, do_path)
    return [g_path, do_path]


if __name__ == "__main__":
    main()
