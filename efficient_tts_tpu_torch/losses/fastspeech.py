"""FastSpeech-style loss: mel regression + duration L1 (counterpart of
`efficient_tts_tpu/losses/fastspeech.py:fastspeech_loss`).

Mel MSE (or L1 with use_mse=False) plus duration L1 in the log domain.
Masked means are sum(err * mask) / max(sum(mask), 1). `loss_normalize`:
"frame" is one global masked mean (an utterance weighs by its frame
count); "utterance" a masked mean per utterance, then a mean over the
utterances with at least one token. Any other value raises (the JAX
function treats it as "frame").
"""

from __future__ import annotations

import torch

LOSS_NORMALIZE = ("frame", "utterance")


def fastspeech_loss(mel_pred, mel_target, dur_pred, dur_target, text_mask, mel_mask, use_masking: bool = True,
                    use_mse: bool = True, loss_normalize: str = "frame"):
    """(mel_loss, duration_loss) scalars. mel [B, T2, n_mels], durations [B,
    T1] (log domain), text_mask [B, T1] and mel_mask [B, T2] True = valid."""
    if loss_normalize not in LOSS_NORMALIZE:
        raise ValueError(f"loss_normalize={loss_normalize!r}: expected one of {LOSS_NORMALIZE}")
    mel_err = torch.square(mel_pred - mel_target) if use_mse else torch.abs(mel_pred - mel_target)
    dur_err = torch.abs(dur_pred - dur_target)
    if not use_masking:
        return mel_err.mean(), dur_err.mean()
    mel_maskf = mel_mask.to(mel_err.dtype)[:, :, None]
    text_maskf = text_mask.to(dur_err.dtype)
    if loss_normalize == "utterance":
        mel_frames = mel_maskf.sum(dim=(1, 2)) * mel_err.shape[-1]
        per_mel = (mel_err * mel_maskf).sum(dim=(1, 2)) / torch.clamp(mel_frames, min=1.0)
        tokens = text_maskf.sum(dim=1)
        per_dur = (dur_err * text_maskf).sum(dim=1) / torch.clamp(tokens, min=1.0)
        valid = (tokens > 0).to(mel_err.dtype)
        n_valid = torch.clamp(valid.sum(), min=1.0)
        return (per_mel * valid).sum() / n_valid, (per_dur * valid).sum() / n_valid
    mel_loss = (mel_err * mel_maskf).sum() / torch.clamp(mel_maskf.sum() * mel_err.shape[-1], min=1.0)
    dur_loss = (dur_err * text_maskf).sum() / torch.clamp(text_maskf.sum(), min=1.0)
    return mel_loss, dur_loss
