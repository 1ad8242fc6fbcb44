"""DSP: the mel filterbank, the Hann window, the host log-mel in numpy and
the log-mel on tensors for the vocoder's GAN step (counterparts of
`efficient_tts_tpu/dsp/`)."""
