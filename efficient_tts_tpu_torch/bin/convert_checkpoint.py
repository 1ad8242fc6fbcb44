"""Convert the reference's PyTorch checkpoints into the port's checkpoints.

    python -m efficient_tts_tpu_torch.bin.convert_checkpoint \\
        --torch_checkpoint checkpoint-320000steps.pkl \\
        --model EfficientTTSCNN --num_symbols 76 \\
        --outdir exp/lj_imported [--config config.yml]

Counterpart of `efficient_tts_tpu/bin/convert_checkpoint.py`. Reads the
reference trainer's `torch.save` dict ({"model": sd, "steps", "epochs"})
or a HiFi-GAN generator file ({"generator": sd}), maps the state dict
through `compat/torch_import.py` and writes `outdir/checkpoint-{steps}steps`
with `train/checkpoint.py`:
  * EfficientTTSCNN: {params, opt_state, step}, the optimizer state fresh
    from the config's optimizer block (`train/optim.py:optimizer_from_dict`;
    Adam + WarmupLR by default) and the step the file's `steps`, so that
    `bin/train.py --pretrain` or `--resume` and `bin/inference.py` read it.
    A folded file gives plain res-conv layers: the inference CLI reads them
    as they are; to train them, set `use_weight_norm: false` in the config.
  * HiFiGANGenerator: {gen: {params, opt_state}, step}, the generator
    trainable (weight norm as {v, g}): `bin/inference.py
    --vocoder_checkpoint` folds it, and `bin/train_vocoder.py --resume`
    fine-tunes it, its discriminators starting from their seeded init. A
    folded generator file has no weight norm to train: pass it to the
    inference CLI as it is.
The model's widths come from `--config` (`model_params` or
`vocoder_params`), else the defaults (EFTS-CNN with `--num_symbols`,
HiFi-GAN V1). Like the JAX tool it writes no `config.yml`: put the config
beside the checkpoint, where the CLIs look for it. Conversion is host work
and runs on the CPU; it needs no card and touches none.
"""

from __future__ import annotations

import argparse
import logging


def get_parser():
    p = argparse.ArgumentParser(description="Import the reference's torch checkpoints")
    p.add_argument("--torch_checkpoint", required=True)
    p.add_argument("--model", default="EfficientTTSCNN", choices=["EfficientTTSCNN", "HiFiGANGenerator"])
    p.add_argument("--outdir", required=True)
    p.add_argument("--num_symbols", type=int, default=76)
    p.add_argument("--config", default=None,
                   help="optional YAML with model_params / vocoder_params overriding defaults")
    return p


def main(argv=None) -> str:
    """Convert as the arguments say; returns the written checkpoint's path."""
    args = get_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    from efficient_tts_tpu_torch.compat import torch_import
    from efficient_tts_tpu_torch.train.checkpoint import save_checkpoint
    from efficient_tts_tpu_torch.train.state import create_state, named_params
    from efficient_tts_tpu_torch.utils.config import load_config

    state = torch_import.load_reference_checkpoint(args.torch_checkpoint)
    sd, steps = state["model"], state["steps"]
    logging.info("loaded %d tensors at step %d", len(sd), steps)
    config = load_config(args.config) if args.config else {}

    if args.model == "EfficientTTSCNN":
        from efficient_tts_tpu_torch.models.efficient_tts import EftsCNNConfig
        from efficient_tts_tpu_torch.train.optim import optimizer_from_dict
        from efficient_tts_tpu_torch.utils.config import model_config_from_dict

        cfg = (model_config_from_dict(config) if args.config
               else EftsCNNConfig(num_symbols=args.num_symbols, dropout_rate=0.0, use_masking=True))
        model = torch_import.efts_cnn_from_state_dict(sd, cfg, device="cpu", trainable=True)
        train_state = create_state(model, optimizer_from_dict(config))
    else:
        from efficient_tts_tpu_torch.train.optim import HiFiGANAdam
        from efficient_tts_tpu_torch.utils.config import vocoder_config_from_dict

        gen = torch_import.hifigan_train_generator_from_state_dict(sd, vocoder_config_from_dict(config), device="cpu")
        train_state = {"gen": {"params": gen, "opt_state": HiFiGANAdam().init(named_params(gen))}}
    train_state["step"] = steps
    path = save_checkpoint(args.outdir, train_state)
    logging.info("wrote %s", path)
    return path


if __name__ == "__main__":
    main()
