"""The plain reference: EFTS-CNN, EFTS-Transformer and HiFi-GAN in plain PyTorch, f32.

It imports nothing of the port and nothing of JAX. It reads the weights as
the tree that `port_bench/weights.py` makes (the JAX package's layout) and
the inputs the drivers make, and works out again whatever the port derives
from them (folded weights, kernel layouts, masks, text ids).

`Ops` carries the precision: f32 with TF32 off (the configurations'
precision), or TF32, the control of one step below. On the card the
control runs cuBLAS and cuDNN in TF32; on the CPU, which has no TF32, it
rounds the operands of every product and convolution to TF32 (10 mantissa
bits, ties away from zero) and computes in f32.
"""
