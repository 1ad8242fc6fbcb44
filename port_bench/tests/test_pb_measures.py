"""The benchmark's arithmetic on made-up records: tails from due times, rates, idle shares, work counts."""

from __future__ import annotations

import math

import numpy as np
import pytest

from port_bench import corpus, spec
from port_bench.record import breakdown, kernel_seconds, reduce_trace, short_name
from port_bench.tools.knee import growth
from port_bench.work import flops, roofline


def _latency(due, done, end):
    """As the serving driver forms it: never completed -> until the wait's end."""
    done = np.asarray(done, float)
    return np.where(np.isnan(done), end - np.asarray(due), done - np.asarray(due))


def test_p95_counts_from_due_and_shed_requests_never_complete():
    due = np.arange(100) * 0.01
    done = due + 0.05
    done[[3, 50]] = np.nan  # shed: never came back
    lat = _latency(due, done, end=70.0)
    assert lat[3] == pytest.approx(70.0 - 0.03) and lat[50] == pytest.approx(69.5)
    # two of 100 never complete: the 95th percentile still lands among the completed ones
    assert np.percentile(lat, 95) == pytest.approx(0.05)
    done[:6] = np.nan  # six of 100 never complete: the tail is the wait's end
    assert np.percentile(_latency(due, done, 70.0), 95) > 60.0


def test_latency_runs_from_due_not_from_sent():
    """A late generator counts against the request: due 0, sent 0.2, done 0.25 -> 250 ms."""
    assert _latency([0.0], [0.25], 1.0)[0] == pytest.approx(0.25)


def test_rate_over_the_window():
    reader = spec.metric_reader("synth_mfu")
    record = {"flops": 495e12 * 2.0, "window_s": 4.0}
    assert reader(record) == pytest.approx(50.0)
    assert spec.metric_reader("pipeline.pad_share")({"real_frames": 300, "padded_frames": 400}) == pytest.approx(25.0)
    assert spec.metric_reader("pipeline.dispatch_ms")({"dispatch_s": [0.002, 0.004]}) == pytest.approx(3.0)
    assert spec.metric_reader("serve.mean_batch")({"batch_sizes": [4, 8, 12]}) == pytest.approx(8.0)
    assert spec.metric_reader("serve.dispatch_ms")({"dispatch_s": 0.3, "batches": 100}) == pytest.approx(3.0)
    lag = list(np.arange(101) * 1e-3)
    assert spec.metric_reader("loadgen.lag_p95_ms")({"lag_s": lag}) == pytest.approx(95.0)


def _trace():
    """Two kernels overlapping (0-10, 5-20 µs), one after a gap (40-50 µs), a
    copy (60-62 µs), and host ops around the gaps, in a window of 100 µs."""
    return [
        {"ph": "X", "cat": "kernel", "name": "void k3<256>(float*)", "ts": 0.0, "dur": 10.0},
        {"ph": "X", "cat": "kernel", "name": "void k3<256>(float*)", "ts": 5.0, "dur": 15.0},
        {"ph": "X", "cat": "kernel", "name": "other", "ts": 40.0, "dur": 10.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 60.0, "dur": 2.0},
        {"ph": "X", "cat": "user_annotation", "name": "outer", "ts": 0.0, "dur": 100.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mul", "ts": 25.0, "dur": 10.0},
        {"ph": "i", "cat": "kernel", "name": "instant", "ts": 1.0},
    ]


def test_idle_share_from_a_trace():
    t = reduce_trace(_trace(), window_s=100e-6)
    assert t["busy_s"] == pytest.approx(32e-6)  # 0-20, 40-50, 60-62
    assert t["launches"] == 3
    assert spec.metric_reader("idle_share.synth")({"trace": t}) == pytest.approx(68.0)
    # the gap 20-40 is named by the host op at its middle (30 µs), the gap 50-60 by the outer span
    assert t["idle_gaps"] == pytest.approx({"aten::mul": 20e-6, "outer": 10e-6})
    assert kernel_seconds(t, "k3") == (pytest.approx(25e-6), 2)
    b = breakdown(t)
    assert b["device_ops"][0] == ["k3<256>", pytest.approx(25e-6)]
    assert b["idle_gaps"][0][0] == "aten::mul"


def test_readers_give_nothing_without_device_work():
    t = reduce_trace([], window_s=1.0)
    for name in ("idle_share.train", "train.launches_per_step"):
        assert spec.metric_reader(name)({"trace": {**t, "result": 3}}) is None
    assert spec.metric_reader("k3_roofline")({"trace": {**t, "k3_bound_s": 1.0}}) is None


def test_short_kernel_names():
    assert short_name("void (anonymous namespace)::mrf_conv_wgmma_tf32x3_kernel<256>(CUtensorMap, float)") == \
        "mrf_conv_wgmma_tf32x3_kernel<256>"
    assert short_name("Memcpy DtoD (Device -> Device)") == "Memcpy DtoD "


def test_conv_and_generator_flops_by_hand():
    assert flops.conv1d_flops(10, 4, 6, 3) == 2 * 10 * 3 * 4 * 6
    v = {"upsample_initial_channel": 8, "upsample_rates": [2], "upsample_kernel_sizes": [4], "num_mels": 3,
         "resblock": "1", "resblock_kernel_sizes": [3], "resblock_dilation_sizes": [[1]]}
    # conv_pre 2*5*7*3*8, the transposed conv at 10 outputs with ceil(4/2) = 2 taps 8 -> 4,
    # one ResBlock1 of two convs 4 -> 4 at k 3, conv_post 2*10*7*4*1
    want = 2 * 5 * 7 * 3 * 8 + 2 * 10 * 2 * 8 * 4 + 2 * (2 * 10 * 3 * 4 * 4) + 2 * 10 * 7 * 4
    assert flops.generator_flops(v, 5) == want


def test_transformer_layer_flops_by_hand():
    p = {"n_channels": 4, "ff_hidden": 8, "kernel_size": 3, "n_text_encoder_layer": 1, "n_mel_encoder_layer": 0,
         "n_decoder_layer": 0, "n_duration_layer": 0, "odim": 2}
    # four linears 4x4, attention's two products at T*T, two k3 convs 4 -> 8 -> 4, at T = 5
    layer = 4 * (2 * 5 * 16) + 4 * 25 * 4 + 2 * (2 * 5 * 3 * 4 * 8)
    text_kv = 2 * (2 * 5 * 16)
    mel = 2 * 7 * 2 * 4 + 2 * 2.0 * 5 * 7 * 4 + 2 * 7 * 4 * 2
    dur = 2 * 5 * 4
    assert flops.efts_transformer_train_forward_flops(p, 5, 7) == pytest.approx(layer + text_kv + mel + dur)
    assert flops.train_step_flops("EfficientTTSTransformer", p, [5], [7]) == pytest.approx(3 * (layer + text_kv +
                                                                                              mel + dur))


def test_mrf_bound_by_hand():
    # 100 samples at 32 channels, taps [3, 3]: ops 2*100*32*32*6, bytes 2*100*32*4 + 2*3*32*32*4 + 2*32*4
    ops, nbytes = 2 * 100 * 32 * 32 * 6, 2 * 100 * 32 * 4 + 2 * 3 * 32 * 32 * 4 + 2 * 32 * 4
    want = max(ops / 495e12, nbytes / 3.35e12)
    assert roofline.mrf_stage_bound_s(100, 32, [3, 3], 4, 4, "tf32") == pytest.approx(want)
    v = {"upsample_initial_channel": 64, "upsample_rates": [2], "resblock_kernel_sizes": [3],
         "resblock_dilation_sizes": [[1]]}
    # two rows of 30 and 20 frames: 100 samples at 32 channels, one branch of one dilation (two convs)
    assert roofline.generator_mrf_bound_s(v, [30, 20]) == pytest.approx(want)


def test_sentences_have_the_lengths_asked_for():
    from port_bench.reference.text import encode

    rng = np.random.default_rng(3)
    for n in [2, 3, 9, 10, 11, 17, 58, 161]:
        s = corpus.sentence(rng, n)
        assert len(s) == n and len(encode(s)) == n and s.endswith(".")


def test_plans_fix_the_sizes_across_seeds():
    a = corpus.planned(corpus.beta_quantiles(64), 7)
    assert np.array_equal(a, corpus.planned(corpus.beta_quantiles(64), 7))
    assert a.min() > corpus.MIN_S and a.max() < corpus.MAX_S
    assert abs(a.mean() - corpus.MEAN_S) < 0.1
    gaps = corpus.exponential_quantiles(4000, 0.01)
    assert gaps.mean() == pytest.approx(0.01, rel=0.01)


def test_growth_of_latencies():
    assert growth(np.ones(50)) == pytest.approx(1.0)
    assert growth(np.linspace(0.1, 1.0, 50)) > 1.5
    assert math.isnan(growth(np.ones(5)))
