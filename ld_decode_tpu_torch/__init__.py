"""ld-decode-tpu-torch: the PyTorch/CUDA port of the ld_decode_tpu decoder.

The JAX package `ld_decode_tpu` stays the reference; this package mirrors
its layout (ops/, tbc/, audio/, vbi/, io/, models/, tape/, utils/).  It
imports neither jax nor the JAX package: the numpy host modules it needs
(params, log, loaders, metadata, despackle, encode, the Philips host
slicer, the EFM digital-audio chain, the IEC 60857 interpreter and the
filter-design tools fdls, filtertools and filtermaker) are copies, which
tests/test_torch_hostcopies.py and tests/test_torch_efm.py hold equal to
the originals.
"""

import torch

# Signal-path convolutions and matmuls must run in full float32: TF32 keeps
# ~3 decimal digits and costs fidelity on FIR/FFT paths.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
