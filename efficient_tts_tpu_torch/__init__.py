"""PyTorch/CUDA port of efficient_tts_tpu for NVIDIA Hopper (H100).

Batched synthesis from text ids to waveform: EFTS-CNN durations and mel
decode, then the HiFi-GAN V1 generator, whose MRF stages run through a
hand-written CUDA kernel (`ops/mrf.py`, `csrc/mrf_stage.cu`). Public
functions keep the JAX package's channels-last [B, T, C] layout.

Entry points run on the card (`device="cuda"`) unless the caller passes
`device="cpu"`; without a card they raise instead of running on the CPU.
"""

from efficient_tts_tpu_torch.version import __version__  # noqa: F401
