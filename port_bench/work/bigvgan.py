"""The least bytes and time of BigVGAN's anti-aliased activations (`bigvgan_act_roofline`).

Each activation reads its input and writes its output once, in f32, per
channel-sample at the 1x rate of its stage, at each utterance's real
length: the 2x upsampled signal need never leave the chip, so the bound
does not depend on how the activation is computed. An AMP block holds two
activations a dilation; the generator one more, before `conv_post`, at the
last stage's width and rate. Against HBM's 3.35 TB/s (`work/roofline.py`);
the activations' few operations a sample (two 6-tap polyphase filters, a
sine) keep them far below the card's peak FLOP/s.
"""

from __future__ import annotations

from port_bench.work.roofline import PEAK_BYTES


def act_bytes(v: dict, mel_lengths, dtype_bytes: int = 4) -> float:
    """Least bytes of every activation of one generator call on rows of
    `mel_lengths` real frames; `v` the configuration's `vocoder_params`."""
    frames = sum(int(m) for m in mel_lengths)
    per_stage = sum(2 * len(dils) for dils in v["resblock_dilation_sizes"])
    channel_samples, up, ch = 0, 1, v["upsample_initial_channel"]
    for u in v["upsample_rates"]:
        up, ch = up * u, ch // 2
        channel_samples += per_stage * frames * up * ch
    channel_samples += frames * up * ch
    return 2.0 * dtype_bytes * channel_samples


def act_bound_s(v: dict, mel_lengths) -> float:
    return act_bytes(v, mel_lengths) / PEAK_BYTES
