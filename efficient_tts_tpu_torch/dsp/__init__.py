"""Host DSP: the mel filterbank, the Hann window and the numpy log-mel
(counterparts of `efficient_tts_tpu/dsp/`). The on-device mel of HiFi-GAN
training is not ported yet."""
