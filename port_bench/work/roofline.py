"""The card's peaks and the least time of the MRF stage's work.

Peaks: NVIDIA's H100 SXM data sheet, dense, at the full 700 W power limit.
f32 work is held against TF32's 495 TFLOP/s: no f32-accurate method on this
card is faster, so no honest change reads above 100% (the port's f32 MRF
kernel forms each product from three TF32 products today; a third of the
TF32 peak would describe that method, not the work). cuDNN's f32 convs
outside the kernels run on the 67 TFLOP/s FP32 units, so an f32 model's
MFU against 495 stays low by construction.

An MRF stage's least time is the larger of its operations over the peak
and its bytes over HBM's rate: the activations read once and the result
written once at each row's real length, every conv's [k, C, C] weights and
bias once per stage call.
"""

from __future__ import annotations

PEAK_FLOPS = {"bf16": 989e12, "tf32": 495e12, "fp32": 67e12, "int8": 1979e12}
PEAK_BYTES = 3.35e12
F32_PEAK = "tf32"


def mrf_stage_bound_s(samples: int, channels: int, taps, act_bytes: int, weight_bytes: int, peak: str) -> float:
    """Least seconds of one stage call over `samples` real time steps (summed
    over the batch's rows) at `channels`, its convs of kernel sizes `taps`."""
    ops = 2.0 * samples * channels * channels * sum(taps)
    nbytes = 2 * samples * channels * act_bytes + sum(k * channels * channels for k in taps) * weight_bytes
    nbytes += len(taps) * channels * 4
    return max(ops / PEAK_FLOPS[peak], nbytes / PEAK_BYTES)


def generator_mrf_bound_s(v: dict, mel_lengths, act_bytes: int = 4, peak: str = F32_PEAK) -> float:
    """Least seconds of every MRF stage of one generator call on a batch whose
    rows have `mel_lengths` real frames."""
    taps = [k for k, dils in zip(v["resblock_kernel_sizes"], v["resblock_dilation_sizes"]) for _ in dils
            for _ in range(2)]
    frames = sum(int(m) for m in mel_lengths)
    total, up, ch = 0.0, 1, v["upsample_initial_channel"]
    for u in v["upsample_rates"]:
        up, ch = up * u, ch // 2
        total += mrf_stage_bound_s(frames * up, ch, taps, act_bytes, act_bytes, peak)
    return total
