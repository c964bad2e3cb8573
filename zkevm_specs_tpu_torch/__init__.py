"""PyTorch/CUDA port of the zkEVM constraint checker.

A second package beside ``zkevm_specs_tpu`` (the JAX reference, which it
never imports).  Module paths mirror the JAX package so each module's
counterpart is found by name.  Limbs are ``torch.int64`` tensors holding
16-bit limbs; the hot arithmetic of every ported path runs through
hand-written CUDA kernels (``csrc/``) with a plain PyTorch version of each
beside its wrapper, used only for CPU tensors.
"""
