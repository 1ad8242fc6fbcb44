"""Cells of the benchmark at a size a CPU test holds: the real configurations with narrow widths and short plans."""

from __future__ import annotations

import copy

from port_bench import spec

TINY_MODEL = {"EfficientTTSCNN": {"n_channels": 32, "symbol_embedding_dim": 32, "n_text_encoder_layer": 2,
                                  "n_mel_encoder_layer": 1, "n_decoder_layer": 2},
              "EfficientTTSTransformer": {"n_channels": 32, "n_heads": 2, "ff_hidden": 64, "n_text_encoder_layer": 1,
                                          "n_mel_encoder_layer": 1, "n_decoder_layer": 1}}
TINY_VOCODER = {"upsample_initial_channel": 32, "upsample_rates": [4, 4], "upsample_kernel_sizes": [8, 8],
                "resblock_kernel_sizes": [3, 5], "resblock_dilation_sizes": [[1, 3], [1, 3]], "hop_size": 16}
TINY_TRAFFIC = {"synth": {"batch": 3, "batches": 2, "check_rows": 3},
                "train": {"batches": 3},
                "serve": {"pool": 64, "rate": 20.0, "warm_seconds": 0.3, "check_requests": 4}}


def tiny_cell(name: str, seed: int = 5, **traffic) -> spec.Cell:
    """The cell `name` of BENCHMARK.json, narrowed, on the CPU. Durations are
    cut to 0.1-0.3 s of audio so that a run takes seconds."""
    cell = copy.deepcopy(spec.load_cell(name))
    cfg = cell.config
    cfg["model_params"].update(TINY_MODEL[cfg["model_name"]])
    cfg["vocoder_params"].update(TINY_VOCODER)
    cfg["batch_size"] = 4
    cell.traffic.update(TINY_TRAFFIC[cell.traffic["driver"]], **traffic)
    cell.seed, cell.device = seed, "cpu"
    return cell
