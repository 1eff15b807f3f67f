"""The paper's six CNNs (Table I), block-structured like torchvision.

Block boundaries replicate the flattened top-level children of the
torchvision implementations — that is what the paper partitions at, and
it makes our block counts match Table I (MobileNetV2 21, ResNet18 14,
InceptionV3 22, ResNet50 22, AlexNet 21, VGG16 39).

Parameter counts are verified against the canonical torchvision counts
in the reference's tests (ResNet18 11,689,512 / ResNet50 25,557,032 /
AlexNet 61,100,840 / VGG16 138,357,544 at 1000 classes; MobileNetV2
2,236,682 at the paper's 10 classes), and the port's tests hold
``param_count`` and ``block_graph`` equal to the reference's.

A ``CNNModel`` is an ``nn.Module`` whose weights live in its layers:
``init(generator, device)`` draws them from a seeded generator, and
``from_reference(params_np)`` loads the JAX reference's parameter
pytree (leaves as numpy arrays) so both packages compute the same
function.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch import nn

from ...core.blocks import Block, BlockGraph
from .layers import (AdaptiveAvgPool, BatchNorm, Conv2D, Dropout, Flatten,
                     Layer, Linear, Parallel, Pool, ReLU, Residual,
                     Sequential, conv_bn_relu)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller
    names another.  Asking for CUDA where there is none raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not "
                           "available; pass device='cpu' to run on the CPU")
    return dev


class CNNModel(nn.Module):
    def __init__(self, name: str, blocks: list[tuple[str, Layer]],
                 input_hw: int, in_channels: int = 3):
        super().__init__()
        self.name = name
        self.input_hw = input_hw          # the paper's operating resolution
        self.in_channels = in_channels
        self.layers = nn.ModuleList(layer for _, layer in blocks)
        self.names = [n for n, _ in blocks]

    @property
    def blocks(self) -> list[tuple[str, Layer]]:
        return list(zip(self.names, self.layers))

    # ----------------------------------------------------------------- #
    def init(self, generator: torch.Generator, device=None) -> "CNNModel":
        """Draw every weight from ``generator`` (a CPU generator: the
        same seed gives the same weights on any device), move to
        ``device`` (default ``cuda``) and switch to inference mode."""
        dev = resolve_device(device)
        for layer in self.layers:
            layer.reset(generator)
        return self.to(dev).eval()

    def from_reference(self, params_np) -> "CNNModel":
        """Load the reference's params (``jax.tree.map(np.asarray,
        params)``): conv HWIO → OIHW, linear ``(fin, fout)`` →
        ``(fout, fin)``, BN scale/bias/mean/var as they are."""
        if len(params_np) != len(self.layers):
            raise ValueError(f"{len(params_np)} parameter blocks for "
                             f"{len(self.layers)} model blocks")
        for layer, p in zip(self.layers, params_np):
            layer.load_reference(p)
        return self.eval()

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def forward(self, x: torch.Tensor, lo: int = 0,
                hi: int | None = None) -> torch.Tensor:
        for layer in self.layers[lo:hi]:
            x = layer(x)
        return x

    @torch.no_grad()
    def apply(self, x: torch.Tensor) -> torch.Tensor:
        return self(x)

    @torch.no_grad()
    def apply_range(self, x: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
        """Run blocks[lo:hi] — the unit a pipeline stage executes."""
        return self(x, lo, hi)

    def block_fns(self) -> tuple[list[str], list[nn.Module]]:
        """(block names, the blocks): each block is a module that maps
        the previous block's activation to its own (the unit the
        profiler times)."""
        return list(self.names), list(self.layers)

    def param_count(self) -> int:
        return sum(layer.param_count() for layer in self.layers)

    # ----------------------------------------------------------------- #
    def block_graph(self, input_hw: int | None = None) -> BlockGraph:
        """Analytic per-sample BlockGraph for the partitioner."""
        hw = input_hw or self.input_hw
        s = (1, hw, hw, self.in_channels)
        in_bytes = int(np.prod(s)) * 4
        blocks = []
        for name, layer in self.blocks:
            out = layer.out_shape(s)
            fl = layer.flops(s)
            ef = layer.eff_flops(s)
            blocks.append(Block(
                name=name,
                flops=fl,
                weight_bytes=layer.param_count() * 4,
                out_bytes=int(np.prod(out)) * 4,
                act_bytes=(int(np.prod(s)) + int(np.prod(out))) * 4,
                eff=(fl / ef) if ef > 0 else 1.0,
            ))
            s = out
        return BlockGraph(name=self.name, blocks=tuple(blocks),
                          input_bytes=in_bytes,
                          output_bytes=int(np.prod(s)) * 4)

    def out_shape(self, batch: int, input_hw: int | None = None):
        hw = input_hw or self.input_hw
        s = (batch, hw, hw, self.in_channels)
        for layer in self.layers:
            s = layer.out_shape(s)
        return s


# ========================================================================= #
# MobileNetV2
# ========================================================================= #
def _inverted_residual(inp: int, oup: int, stride: int, expand: int) -> Layer:
    hidden = inp * expand
    layers = []
    if expand != 1:
        layers.append(conv_bn_relu(inp, hidden, 1, relu_cap=6.0))
    layers += [
        conv_bn_relu(hidden, hidden, 3, stride, 1, groups=hidden, relu_cap=6.0),
        Sequential([Conv2D(hidden, oup, 1, bias=False), BatchNorm(oup)]),
    ]
    body = Sequential(layers)
    if stride == 1 and inp == oup:
        return Residual(body, post_relu=False)
    return body


def mobilenet_v2(num_classes: int = 10) -> CNNModel:
    cfg = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
           (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
    blocks: list[tuple[str, Layer]] = [
        ("features.0_stem", conv_bn_relu(3, 32, 3, 2, 1, relu_cap=6.0))]
    cin, idx = 32, 1
    for t, c, n, s in cfg:
        for i in range(n):
            blocks.append((f"features.{idx}_ir",
                           _inverted_residual(cin, c, s if i == 0 else 1, t)))
            cin, idx = c, idx + 1
    blocks.append(("features.18_head", conv_bn_relu(cin, 1280, 1, relu_cap=6.0)))
    blocks.append(("avgpool", Sequential([AdaptiveAvgPool(1), Flatten()])))
    blocks.append(("classifier", Sequential([Dropout(0.2),
                                             Linear(1280, num_classes)])))
    return CNNModel("mobilenetv2", blocks, input_hw=224)


# ========================================================================= #
# ResNet 18 / 50
# ========================================================================= #
def _basic_block(cin: int, cout: int, stride: int) -> Layer:
    body = Sequential([
        Conv2D(cin, cout, 3, stride, 1, bias=False), BatchNorm(cout), ReLU(),
        Conv2D(cout, cout, 3, 1, 1, bias=False), BatchNorm(cout),
    ])
    short = None
    if stride != 1 or cin != cout:
        short = Sequential([Conv2D(cin, cout, 1, stride, bias=False),
                            BatchNorm(cout)])
    return Residual(body, short, post_relu=True)


def _bottleneck(cin: int, mid: int, cout: int, stride: int) -> Layer:
    body = Sequential([
        Conv2D(cin, mid, 1, bias=False), BatchNorm(mid), ReLU(),
        Conv2D(mid, mid, 3, stride, 1, bias=False), BatchNorm(mid), ReLU(),
        Conv2D(mid, cout, 1, bias=False), BatchNorm(cout),
    ])
    short = None
    if stride != 1 or cin != cout:
        short = Sequential([Conv2D(cin, cout, 1, stride, bias=False),
                            BatchNorm(cout)])
    return Residual(body, short, post_relu=True)


def _resnet_stem() -> list[tuple[str, Layer]]:
    return [("conv1", Conv2D(3, 64, 7, 2, 3, bias=False)),
            ("bn1", BatchNorm(64)),
            ("relu", ReLU()),
            ("maxpool", Pool("max", 3, 2, 1))]


def resnet18(num_classes: int = 10) -> CNNModel:
    blocks = _resnet_stem()
    plan = [(64, 64, 1), (64, 64, 1), (64, 128, 2), (128, 128, 1),
            (128, 256, 2), (256, 256, 1), (256, 512, 2), (512, 512, 1)]
    for i, (cin, cout, s) in enumerate(plan):
        blocks.append((f"layer_bb{i}", _basic_block(cin, cout, s)))
    blocks.append(("avgpool", Sequential([AdaptiveAvgPool(1), Flatten()])))
    blocks.append(("fc", Linear(512, num_classes)))
    return CNNModel("resnet18", blocks, input_hw=224)


def resnet50(num_classes: int = 10) -> CNNModel:
    blocks = _resnet_stem()
    i = 0
    cin = 64
    for mid, n, stride in [(64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2)]:
        cout = mid * 4
        for j in range(n):
            blocks.append((f"layer_bn{i}",
                           _bottleneck(cin, mid, cout, stride if j == 0 else 1)))
            cin = cout
            i += 1
    blocks.append(("avgpool", Sequential([AdaptiveAvgPool(1), Flatten()])))
    blocks.append(("fc", Linear(2048, num_classes)))
    return CNNModel("resnet50", blocks, input_hw=224)


# ========================================================================= #
# AlexNet
# ========================================================================= #
def alexnet(num_classes: int = 10) -> CNNModel:
    f = [Conv2D(3, 64, 11, 4, 2), ReLU(), Pool("max", 3, 2),
         Conv2D(64, 192, 5, 1, 2), ReLU(), Pool("max", 3, 2),
         Conv2D(192, 384, 3, 1, 1), ReLU(),
         Conv2D(384, 256, 3, 1, 1), ReLU(),
         Conv2D(256, 256, 3, 1, 1), ReLU(), Pool("max", 3, 2)]
    blocks = [(f"features.{i}", l) for i, l in enumerate(f)]
    blocks.append(("avgpool", Sequential([AdaptiveAvgPool(6), Flatten()])))
    c = [Dropout(), Linear(256 * 36, 4096), ReLU(),
         Dropout(), Linear(4096, 4096), ReLU(), Linear(4096, num_classes)]
    blocks += [(f"classifier.{i}", l) for i, l in enumerate(c)]
    return CNNModel("alexnet", blocks, input_hw=224)


# ========================================================================= #
# VGG16
# ========================================================================= #
def vgg16(num_classes: int = 10) -> CNNModel:
    cfg = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
           512, 512, 512, "M", 512, 512, 512, "M"]
    f: list[Layer] = []
    cin = 3
    for v in cfg:
        if v == "M":
            f.append(Pool("max", 2, 2))
        else:
            f += [Conv2D(cin, v, 3, 1, 1), ReLU()]
            cin = v
    blocks = [(f"features.{i}", l) for i, l in enumerate(f)]
    blocks.append(("avgpool", Sequential([AdaptiveAvgPool(7), Flatten()])))
    c = [Linear(512 * 49, 4096), ReLU(), Dropout(),
         Linear(4096, 4096), ReLU(), Dropout(), Linear(4096, num_classes)]
    blocks += [(f"classifier.{i}", l) for i, l in enumerate(c)]
    return CNNModel("vgg16", blocks, input_hw=224)


# ========================================================================= #
# InceptionV3
# ========================================================================= #
def _c(cin, cout, k, s=1, p=0):
    return conv_bn_relu(cin, cout, k, s, p)


def _inception_a(cin: int, pool_features: int) -> Layer:
    return Parallel([
        _c(cin, 64, 1),
        Sequential([_c(cin, 48, 1), _c(48, 64, 5, 1, 2)]),
        Sequential([_c(cin, 64, 1), _c(64, 96, 3, 1, 1), _c(96, 96, 3, 1, 1)]),
        Sequential([Pool("avg", 3, 1, 1), _c(cin, pool_features, 1)]),
    ])


def _inception_b(cin: int) -> Layer:
    return Parallel([
        _c(cin, 384, 3, 2),
        Sequential([_c(cin, 64, 1), _c(64, 96, 3, 1, 1), _c(96, 96, 3, 2)]),
        Pool("max", 3, 2),
    ])


def _inception_c(cin: int, c7: int) -> Layer:
    return Parallel([
        _c(cin, 192, 1),
        Sequential([_c(cin, c7, 1), _c(c7, c7, (1, 7), 1, (0, 3)),
                    _c(c7, 192, (7, 1), 1, (3, 0))]),
        Sequential([_c(cin, c7, 1), _c(c7, c7, (7, 1), 1, (3, 0)),
                    _c(c7, c7, (1, 7), 1, (0, 3)),
                    _c(c7, c7, (7, 1), 1, (3, 0)),
                    _c(c7, 192, (1, 7), 1, (0, 3))]),
        Sequential([Pool("avg", 3, 1, 1), _c(cin, 192, 1)]),
    ])


def _inception_d(cin: int) -> Layer:
    return Parallel([
        Sequential([_c(cin, 192, 1), _c(192, 320, 3, 2)]),
        Sequential([_c(cin, 192, 1), _c(192, 192, (1, 7), 1, (0, 3)),
                    _c(192, 192, (7, 1), 1, (3, 0)), _c(192, 192, 3, 2)]),
        Pool("max", 3, 2),
    ])


def _inception_e(cin: int) -> Layer:
    return Parallel([
        _c(cin, 320, 1),
        Sequential([_c(cin, 384, 1),
                    Parallel([_c(384, 384, (1, 3), 1, (0, 1)),
                              _c(384, 384, (3, 1), 1, (1, 0))])]),
        Sequential([_c(cin, 448, 1), _c(448, 384, 3, 1, 1),
                    Parallel([_c(384, 384, (1, 3), 1, (0, 1)),
                              _c(384, 384, (3, 1), 1, (1, 0))])]),
        Sequential([Pool("avg", 3, 1, 1), _c(cin, 192, 1)]),
    ])


def inception_v3(num_classes: int = 10) -> CNNModel:
    blocks: list[tuple[str, Layer]] = [
        ("Conv2d_1a", _c(3, 32, 3, 2)),
        ("Conv2d_2a", _c(32, 32, 3)),
        ("Conv2d_2b", _c(32, 64, 3, 1, 1)),
        ("maxpool1", Pool("max", 3, 2)),
        ("Conv2d_3b", _c(64, 80, 1)),
        ("Conv2d_4a", _c(80, 192, 3)),
        ("maxpool2", Pool("max", 3, 2)),
        ("Mixed_5b", _inception_a(192, 32)),
        ("Mixed_5c", _inception_a(256, 64)),
        ("Mixed_5d", _inception_a(288, 64)),
        ("Mixed_6a", _inception_b(288)),
        ("Mixed_6b", _inception_c(768, 128)),
        ("Mixed_6c", _inception_c(768, 160)),
        ("Mixed_6d", _inception_c(768, 160)),
        ("Mixed_6e", _inception_c(768, 192)),
        ("Mixed_7a", _inception_d(768)),
        ("Mixed_7b", _inception_e(1280)),
        ("Mixed_7c", _inception_e(2048)),
        ("avgpool", AdaptiveAvgPool(1)),
        ("dropout", Dropout()),
        ("flatten", Flatten()),
        ("fc", Linear(2048, num_classes)),
    ]
    return CNNModel("inceptionv3", blocks, input_hw=299)


# ========================================================================= #
ZOO: dict[str, Callable[..., CNNModel]] = {
    "mobilenetv2": mobilenet_v2,
    "resnet18": resnet18,
    "inceptionv3": inception_v3,
    "resnet50": resnet50,
    "alexnet": alexnet,
    "vgg16": vgg16,
}


def get(name: str, num_classes: int = 10) -> CNNModel:
    try:
        return ZOO[name](num_classes=num_classes)
    except KeyError:
        raise KeyError(f"unknown CNN {name!r}; have {sorted(ZOO)}") from None
