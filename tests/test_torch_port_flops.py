"""The port's FLOP counts and peaks (`utils/flops.py`) against the JAX package's.

The counts are pure arithmetic and must equal `efficient_tts_tpu/utils/
flops.py`'s exactly, on the JAX package's own config classes beside the
port's: HiFi-GAN V1, V2's widths and a ResBlock2 (V3) generator, EFTS-CNN at
several (B, T1, T2), and `bench.py`'s workload at 5.19 TFLOP a batch. The
peaks hold the H100 SXM's dense tensor-core rates only, no TPU figure.
"""

import dataclasses

import pytest

from efficient_tts_tpu.models.efficient_tts import EftsCNNConfig as JEftsCNNConfig
from efficient_tts_tpu.models.hifigan import HiFiGANConfig as JHiFiGANConfig
from efficient_tts_tpu.utils import flops as jflops
from efficient_tts_tpu_torch.models.efficient_tts import EftsCNNConfig
from efficient_tts_tpu_torch.models.hifigan import HiFiGANConfig
from efficient_tts_tpu_torch.utils import flops
from efficient_tts_tpu_torch.utils.roofline import PEAK_OPS

H100 = "NVIDIA H100 80GB HBM3"
VOCODERS = {
    "v1": {},
    "v2": {"upsample_initial_channel": 128},
    "v3": {"resblock": "2", "upsample_rates": (8, 8, 4), "upsample_kernel_sizes": (16, 16, 8),
           "upsample_initial_channel": 256, "resblock_kernel_sizes": (3, 5, 7),
           "resblock_dilation_sizes": ((1, 2), (2, 6), (3, 12))},
}


@pytest.mark.parametrize("name", list(VOCODERS))
@pytest.mark.parametrize("b,t_mel", [(1, 1), (16, 512), (3, 777)])
def test_generator_flops_equal_jax(name, b, t_mel):
    cfg, jcfg = HiFiGANConfig(**VOCODERS[name]), JHiFiGANConfig(**VOCODERS[name])
    assert dataclasses.asdict(cfg).items() >= {k: v for k, v in dataclasses.asdict(jcfg).items()
                                               if k in dataclasses.asdict(cfg)}.items()
    assert flops.generator_flops(cfg, b, t_mel) == jflops.generator_flops(jcfg, b, t_mel) > 0


@pytest.mark.parametrize("b,t1,t2", [(16, 96, 512), (1, 7, 33), (64, 128, 640), (128, 200, 896)])
@pytest.mark.parametrize("params", [dict(num_symbols=76), dict(n_channels=192, k_size=3, n_decoder_layer=2)])
def test_efts_cnn_infer_flops_equal_jax(b, t1, t2, params):
    got = flops.efts_cnn_infer_flops(EftsCNNConfig(**params), b, t1, t2)
    assert got == jflops.efts_cnn_infer_flops(JEftsCNNConfig(**params), b, t1, t2) > 0
    assert flops.conv1d_flops(b, t2, 80, 512, 5) == jflops.conv1d_flops(b, t2, 80, 512, 5)


def _bench_flops():
    """`bench.py`'s workload: EFTS-CNN (76 symbols) into HiFi-GAN V1, B=16, T1=96, T2=512."""
    return flops.efts_cnn_infer_flops(EftsCNNConfig(num_symbols=76), 16, 96, 512) + flops.generator_flops(
        HiFiGANConfig(), 16, 512)


def test_bench_workload_is_5_19_tflop_a_batch():
    want = (jflops.efts_cnn_infer_flops(JEftsCNNConfig(num_symbols=76), 16, 96, 512)
            + jflops.generator_flops(JHiFiGANConfig(), 16, 512))
    assert _bench_flops() == want and round(want / 1e12, 2) == 5.19


def test_peaks_are_the_h100s_and_hold_no_tpu_figure():
    assert flops.peak_flops_for(H100, "bfloat16") == PEAK_OPS["bf16"] == 989e12
    assert flops.peak_flops_for(H100) == flops.peak_flops_for(H100, "float32") == PEAK_OPS["tf32"] == 495e12
    import torch

    assert flops.peak_flops_for(H100, torch.bfloat16) == 989e12
    assert flops.peak_flops_for(H100, torch.float32) == 495e12
    for name in ("tpu_v5e", "tpu_v5_lite", "TPU v4", "NVIDIA A100-SXM4-80GB", "", None):
        assert flops.peak_flops_for(name) is None
    assert not any("tpu" in n.lower() for n in flops.H100_SXM_NAMES)
    assert set(flops.DTYPE_PEAKS.values()) <= set(PEAK_OPS)
    with pytest.raises(ValueError, match="compute_dtype"):
        flops.peak_flops_for(H100, "float16")


def test_f32_mfu_of_the_bench_workload_reads_under_one():
    """The f32 synthesis at 72.73 ms a batch on an H100 (PERF.md section 5)
    against the TF32 peak reads a share under 1; against the 67e12 FP32
    SIMT peak it would read above 1, which is why f32 takes the TF32 peak."""
    per_s = _bench_flops() / 72.73e-3
    assert 0.1 < per_s / flops.peak_flops_for(H100) < 1.0
    assert per_s / PEAK_OPS["fp32"] > 1.0
    assert per_s / flops.peak_flops_for(H100, "bfloat16") < 1.0
