"""Model families of the port: the paper's CNN zoo (``cnn/``) and the LM
serving stack (``lm`` with ``attention``, ``mlp``, ``common`` and the
``config`` dataclass; dense and vlm families so far)."""
