"""Hand-written CUDA kernels for the wire codecs (``csrc/codec_pack.cu``),
their ``ctypes`` binding (``codec_pack``), plain PyTorch versions
(``ref``) and the dispatching wrappers (``ops``)."""
