"""PyTorch/CUDA port of the ParetoPipe reproduction (``src/repro``).

The JAX package beside it stays the reference; this package mirrors its
sub-package paths (``core/``, ``kernels/``, ``models/cnn/``,
``runtime/``) so each module's counterpart is easy to find, and its
tests hold every ported module to the reference.  It imports neither
jax nor anything of ``repro``.
"""
