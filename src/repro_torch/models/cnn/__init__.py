"""Paper's CNN zoo (Table I) — block-structured PyTorch modules."""
from . import layers, zoo
from .zoo import CNNModel, ZOO, get
