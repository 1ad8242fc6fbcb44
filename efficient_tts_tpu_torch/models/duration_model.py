"""The standalone duration model of external-duration workflows.

Counterpart of `efficient_tts_tpu/models/duration_model.py`: a bare
`DurationPredictor` over input features xs [B, T, idim] (PPGs, say), with
optional speaker conditioning, trained with the log-domain MSE of
`losses/duration.py` against given durations; `inference` returns rounded
linear-domain durations. The reference's quirk stays: every conv of the
predictor takes duration_predictor_chans inputs, so without "concat"
speaker integration (which projects [idim + E] to the channels first) idim
must equal duration_predictor_chans; the model raises otherwise.
`train/duration_train_step.py` trains it; `bin/train.py` does not (neither
does the JAX package's CLI).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from efficient_tts_tpu_torch.losses.duration import duration_mse_loss
from efficient_tts_tpu_torch.nn.duration_predictor import DurationPredictor
from efficient_tts_tpu_torch.utils.masks import sequence_mask


@dataclasses.dataclass(frozen=True)
class DurationModelConfig:
    """Same fields and defaults as the JAX package's `DurationModelConfig`."""

    idim: int = 256
    duration_predictor_layers: int = 2
    duration_predictor_chans: int = 256
    duration_predictor_kernel_size: int = 3
    duration_predictor_dropout_rate: float = 0.1
    num_spks: int | None = None
    spk_embed_dim: int | None = None
    spk_embed_integration_type: str = "add"
    use_masking: bool = True
    offset: float = 1.0


class DurationModel(nn.Module):
    def __init__(self, cfg: DurationModelConfig):
        super().__init__()
        concat = cfg.spk_embed_dim is not None and cfg.spk_embed_integration_type == "concat"
        if not concat and cfg.idim != cfg.duration_predictor_chans:
            raise ValueError(f"idim {cfg.idim} must equal duration_predictor_chans "
                             f"{cfg.duration_predictor_chans}: the predictor's first conv takes that many inputs")
        self.cfg = cfg
        self.duration_predictor = DurationPredictor(
            cfg.duration_predictor_chans, cfg.duration_predictor_layers, cfg.duration_predictor_kernel_size,
            idim=cfg.idim, num_spks=cfg.num_spks, spk_embed_dim=cfg.spk_embed_dim,
            spk_embed_integration_type=cfg.spk_embed_integration_type)

    def forward(self, xs, ilens, durations, spkids=None, gen=None, deterministic: bool = True) -> dict:
        """xs [B, T, idim], ilens [B], durations [B, T] linear-domain ->
        {"loss": scalar, "d_outs": [B, T] log-domain}."""
        mask = sequence_mask(ilens, xs.shape[1])
        d_outs = self.duration_predictor(xs, pad_mask=~mask, dropout_rate=self.cfg.duration_predictor_dropout_rate,
                                         gen=gen, deterministic=deterministic, spkids=spkids)
        loss = duration_mse_loss(d_outs, durations, mask if self.cfg.use_masking else torch.ones_like(mask),
                                 offset=self.cfg.offset)
        return {"loss": loss, "d_outs": d_outs}

    @torch.no_grad()
    def inference(self, xs, spkids=None) -> torch.Tensor:
        """Rounded linear-domain durations [B, T]."""
        return self.duration_predictor.infer(xs, offset=self.cfg.offset, to_round=True, spkids=spkids)
