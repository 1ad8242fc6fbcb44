"""Analytic FLOP counts of the synthesis path and the card's dense peaks, for MFU.

Counterpart of `efficient_tts_tpu/utils/flops.py`: `conv1d_flops`,
`generator_flops` and `efts_cnn_infer_flops` are its counts as they are
(pure arithmetic: 2 * MACs of the dense formulations, transposed convs in
sub-pixel form, ceil(K / u) useful taps per output, the alignment's softmax
left out). At `bench.py`'s workload (EFTS-CNN with 76 symbols into HiFi-GAN
V1, B=16, T1=96, T2=512) they give 5.19 TFLOP a batch.

`peak_flops_for` holds no TPU figure. It takes the CUDA device name
(`torch.cuda.get_device_name`) and the synthesis's compute dtype and gives
the H100 SXM's dense tensor-core peak from `utils/roofline.py:PEAK_OPS`: bf16
989e12; f32 the TF32 peak, 495e12, since the port's f32 synthesis runs its
MRF stages (94% of the work) as 3xTF32 products on the tensor cores, and
already reads above the 67e12 FP32 SIMT peak (5.19 TFLOP in 72.73 ms on an
H100, about 71e12 FLOP/s). An unknown card gives None.
"""

from __future__ import annotations

import math

from efficient_tts_tpu_torch.utils.roofline import PEAK_OPS

# the device names of the H100 SXM, whose data sheet PEAK_OPS holds
H100_SXM_NAMES = ("H100 80GB HBM3", "H100 SXM")
# the peak that each compute dtype's synthesis runs at, by PEAK_OPS's key
DTYPE_PEAKS = {"bfloat16": "bf16", "float32": "tf32"}


def conv1d_flops(b: int, t_out: int, cin: int, cout: int, k: int) -> float:
    return 2.0 * b * t_out * k * cin * cout


def generator_flops(cfg, b: int, t_mel: int) -> float:
    """HiFi-GAN generator (V1-family) on a [b, t_mel, num_mels] input."""
    ch = cfg.upsample_initial_channel
    t = t_mel
    total = conv1d_flops(b, t, cfg.num_mels, ch, 7)  # conv_pre
    for u, k in zip(cfg.upsample_rates, cfg.upsample_kernel_sizes):
        cout = ch // 2
        t_out = t * u
        total += conv1d_flops(b, t_out, ch, cout, math.ceil(k / u))
        ch, t = cout, t_out
        for rk, dils in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes):
            n_convs = (2 if cfg.resblock == "1" else 1) * len(dils)
            total += n_convs * conv1d_flops(b, t, ch, ch, rk)
    total += conv1d_flops(b, t, ch, 1, 7)  # conv_post
    return total


def efts_cnn_infer_flops(cfg, b: int, t1: int, t2: int) -> float:
    """EFTS-CNN two-stage inference: text encode + duration predictor
    (stage 1) and alignment expansion + decoder (stage 2)."""
    c = cfg.n_channels
    total = 0.0
    # text encoder: n resconv layers + K/V projections
    total += cfg.n_text_encoder_layer * conv1d_flops(b, t1, c, c, cfg.k_size)
    total += 2 * conv1d_flops(b, t1, c, c, 1)
    # duration predictor: n conv k=3 + out proj
    total += cfg.n_duration_layer * conv1d_flops(b, t1, c, c, 3)
    total += conv1d_flops(b, t1, c, 1, 1)
    # alignment reconstruction energies + softmax ~ O(T1*T2) (not a matmul,
    # small) ignored; expansion bmm alpha'^T V:
    total += 2.0 * b * t1 * t2 * c
    # decoder: n resconv + mel head
    total += cfg.n_decoder_layer * conv1d_flops(b, t2, c, c, cfg.k_size)
    total += conv1d_flops(b, t2, c, cfg.odim, 1)
    return total


def peak_flops_for(device_name: str | None, compute_dtype=None) -> float | None:
    """Dense peak FLOP/s of the card named `device_name` for a synthesis in
    `compute_dtype` (None or f32: the TF32 peak; bf16: the bf16 peak, as a
    torch dtype or its name); None for a card this table does not hold."""
    name = "float32" if compute_dtype is None else str(compute_dtype).removeprefix("torch.")
    if name not in DTYPE_PEAKS:
        raise ValueError(f"compute_dtype={compute_dtype!r}: expected one of None, {sorted(DTYPE_PEAKS)}")
    if not device_name or not any(n in device_name for n in H100_SXM_NAMES):
        return None
    return PEAK_OPS[DTYPE_PEAKS[name]]
