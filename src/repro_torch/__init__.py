"""PyTorch/CUDA port of the ViTA reproduction (the JAX package `repro` is
the reference it is held against).

Layout mirrors `repro`: ``kernels/`` (hand-written Hopper kernels beside
their plain PyTorch versions), ``core/`` (quantization, the schedule
compiler and executor), ``configs/`` (the LM architectures), ``models/``
and ``launch/`` (the vision server and the LM slot server).
A tensor's device picks the path: a CUDA tensor launches the port's
kernel, a CPU tensor takes the plain version.  Entry points run on the
card unless the caller asks for the CPU.
"""
