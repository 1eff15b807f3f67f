"""Hand-written CUDA kernels of the port (``csrc/codec_pack.cu`` for the
wire codecs, ``csrc/lm_kernels.cu`` for LM attention and RMSNorm,
``csrc/ssm_scan.cu`` for the Mamba-1 selective scan), their ``ctypes``
bindings (``codec_pack``, ``flash_attention``, ``decode_attention``,
``fused_rmsnorm``, ``ssm_scan``, built by ``_build``), plain
PyTorch versions (``ref``) and the dispatching wrappers (``ops``)."""
