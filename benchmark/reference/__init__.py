"""The benchmark's plain reference of SRGAN x4 and SRGAN-ST: float32
PyTorch with TF32 off, written from the published model (Ledig et al.,
arXiv:1609.04802; the reference code's model.py, loss.py, train.py and
bicubic.py). It imports nothing of the measured program and takes only
what the benchmark hands both sides: the seeded weights by their
state-dict names, the uint8 GT patches and the LR frames.

A `quant(x, role)` function, where given, rounds the operands of every
convolution and matrix product (the control's lower precision,
precision.py); None leaves them in float32.
"""
