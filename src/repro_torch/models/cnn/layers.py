"""CNN layer library as ``nn.Module``s, with cost accounting.

Every layer runs an inference-mode forward pass (BN uses running stats,
dropout is identity, matching the paper's inference benchmarks) and
reports its ``flops``/``eff_flops``/``out_shape``/``param_count`` for an
input shape.  Those analytic numbers are identical to the JAX
reference's, so both packages hand the partitioner the same
``BlockGraph``.

Layout: tensors enter and leave every layer as **NHWC**, fp32, like the
reference, so block boundaries, ``cut_bytes``, wire frames and the
``Flatten`` order feeding the classifiers match it.  Inside a layer,
``x.permute(0, 3, 1, 2)`` of an NHWC-contiguous tensor is a zero-copy
NCHW view in ``channels_last`` memory; the result is permuted back the
same way.  The weights stay contiguous OIHW, so cuDNN may transpose
around a convolution (``PERF.md`` counts these transposes).

Weights follow PyTorch's layouts: convolutions OIHW, linear layers
``(fout, fin)``.  ``load_reference`` takes the reference's parameter
leaves (as numpy arrays) and transposes them into place.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _load(dst: torch.Tensor, src) -> None:
    src = torch.tensor(np.asarray(src), dtype=dst.dtype)
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"weight shape {tuple(src.shape)} does not fit "
                         f"{tuple(dst.shape)}")
    dst.copy_(src)


class Layer(nn.Module):
    """Base: identity forward, zero cost, no parameters."""

    def forward(self, x):
        return x

    def reset(self, generator: torch.Generator) -> None:
        """Draw this layer's initial weights from ``generator``."""

    def load_reference(self, params) -> None:
        """Copy the reference's parameter pytree (numpy leaves) in."""

    def out_shape(self, s):
        return s

    def flops(self, s) -> float:
        return 0.0

    def eff_flops(self, s) -> float:
        """FLOPs weighted by 1/efficiency (depthwise convs run far below
        peak on ARM/PyTorch — calibration of the paper's Fig. 2)."""
        return self.flops(s)

    def param_count(self) -> int:
        return 0


class Conv2D(Layer):
    def __init__(self, cin: int, cout: int, kernel: int | tuple = 3,
                 stride: int | tuple = 1, padding: int | tuple | str = 0,
                 groups: int = 1, bias: bool = True):
        super().__init__()
        self.cin, self.cout, self.kernel = cin, cout, kernel
        self.stride, self.padding, self.groups = stride, padding, groups
        kh, kw = _pair(kernel)
        self.weight = nn.Parameter(torch.zeros(cout, cin // groups, kh, kw))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def reset(self, generator):
        kh, kw = _pair(self.kernel)
        fan_in = self.cin // self.groups * kh * kw
        w = torch.randn(self.weight.shape, generator=generator)
        with torch.no_grad():
            self.weight.copy_(w * (1.0 / math.sqrt(fan_in)))
            if self.bias is not None:
                self.bias.zero_()

    def load_reference(self, params):
        with torch.no_grad():
            _load(self.weight, np.transpose(params["w"], (3, 2, 0, 1)))
            if self.bias is not None:
                _load(self.bias, params["b"])

    def _same_pad(self, h: int, w: int) -> tuple[int, int, int, int]:
        """XLA's "SAME": total = max((⌈n/s⌉-1)·s + k - n, 0), low half
        rounded down → (left, right, top, bottom) for ``F.pad``."""
        (kh, kw), (sh, sw) = _pair(self.kernel), _pair(self.stride)
        th = max((-(-h // sh) - 1) * sh + kh - h, 0)
        tw = max((-(-w // sw) - 1) * sw + kw - w, 0)
        return tw // 2, tw - tw // 2, th // 2, th - th // 2

    def forward(self, x):
        xn = _nchw(x)
        if isinstance(self.padding, str):
            if self.padding.upper() == "SAME":
                xn = F.pad(xn, self._same_pad(xn.shape[2], xn.shape[3]))
            pad = 0
        else:
            pad = _pair(self.padding)
        y = F.conv2d(xn, self.weight, self.bias, _pair(self.stride), pad,
                     groups=self.groups)
        return _nhwc(y)

    def out_shape(self, s):
        n, h, w, _ = s
        kh, kw = _pair(self.kernel)
        sh, sw = _pair(self.stride)
        if isinstance(self.padding, str) and self.padding.upper() == "SAME":
            ho, wo = -(-h // sh), -(-w // sw)
        else:
            ph, pw = _pair(self.padding)
            ho = (h + 2 * ph - kh) // sh + 1
            wo = (w + 2 * pw - kw) // sw + 1
        return (n, ho, wo, self.cout)

    def flops(self, s):
        n, ho, wo, _ = self.out_shape(s)
        kh, kw = _pair(self.kernel)
        return 2.0 * n * ho * wo * kh * kw * (self.cin // self.groups) * self.cout

    def eff_flops(self, s):
        depthwise = self.groups == self.cin and self.groups > 1
        return self.flops(s) / (0.10 if depthwise else 1.0)

    def param_count(self):
        kh, kw = _pair(self.kernel)
        return (kh * kw * (self.cin // self.groups) * self.cout
                + (self.cout if self.bias is not None else 0))


class BatchNorm(Layer):
    """Inference BN in the reference's folded form,
    ``x*inv + (bias - mean*inv)`` with ``inv = rsqrt(var+eps)*scale``."""

    def __init__(self, c: int, eps: float = 1e-5):
        super().__init__()
        self.c, self.eps = c, eps
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def reset(self, generator):
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()
            self.mean.zero_()
            self.var.fill_(1.0)

    def load_reference(self, params):
        with torch.no_grad():
            for name in ("scale", "bias", "mean", "var"):
                _load(getattr(self, name), params[name])

    def forward(self, x):
        inv = torch.rsqrt(self.var + self.eps) * self.scale
        return x * inv + (self.bias - self.mean * inv)

    def flops(self, s):
        return 2.0 * float(np.prod(s))

    def param_count(self):
        return 2 * self.c  # learnable only (running stats excluded, torch-style)


class ReLU(Layer):
    def __init__(self, cap: float | None = None):   # 6.0 for ReLU6
        super().__init__()
        self.cap = cap

    def forward(self, x):
        return x.clamp(min=0.0, max=self.cap)

    def flops(self, s):
        return float(np.prod(s))


class Pool(Layer):
    """Max or average pooling.  Max pads with -inf; average divides by
    ``kh*kw``, counting the padding (torch's ``count_include_pad``).
    ``ceil_mode`` reaches ``out_shape`` only: the reference's ``apply``
    ignores it, and this forward does the same."""

    def __init__(self, kind: str = "max", kernel: int | tuple = 2,
                 stride: int | tuple | None = None,
                 padding: int | tuple = 0, ceil_mode: bool = False):
        super().__init__()
        self.kind, self.kernel, self.stride = kind, kernel, stride
        self.padding, self.ceil_mode = padding, ceil_mode

    def _dims(self):
        kh, kw = _pair(self.kernel)
        sh, sw = _pair(self.stride if self.stride is not None else self.kernel)
        ph, pw = _pair(self.padding)
        return kh, kw, sh, sw, ph, pw

    def forward(self, x):
        kh, kw, sh, sw, ph, pw = self._dims()
        xn = _nchw(x)
        if self.kind == "max":
            y = F.max_pool2d(xn, (kh, kw), (sh, sw), (ph, pw))
        else:
            y = F.avg_pool2d(xn, (kh, kw), (sh, sw), (ph, pw),
                             count_include_pad=True)
        return _nhwc(y)

    def out_shape(self, s):
        n, h, w, c = s
        kh, kw, sh, sw, ph, pw = self._dims()
        rnd = math.ceil if self.ceil_mode else math.floor
        ho = rnd((h + 2 * ph - kh) / sh) + 1
        wo = rnd((w + 2 * pw - kw) / sw) + 1
        return (n, ho, wo, c)

    def flops(self, s):
        n, ho, wo, c = self.out_shape(s)
        kh, kw, *_ = self._dims()
        return float(n * ho * wo * c * kh * kw)


class AdaptiveAvgPool(Layer):
    """torch's adaptive bins (start ⌊i·h/oh⌋, end ⌈(i+1)·h/oh⌉), which is
    also what the reference computes on its non-divisible path."""

    def __init__(self, out_hw: int | tuple = 1):
        super().__init__()
        self.out_hw = out_hw

    def forward(self, x):
        return _nhwc(F.adaptive_avg_pool2d(_nchw(x), _pair(self.out_hw)))

    def out_shape(self, s):
        oh, ow = _pair(self.out_hw)
        return (s[0], oh, ow, s[3])

    def flops(self, s):
        return float(np.prod(s))


class Flatten(Layer):
    """NHWC flatten: features in (h, w, c) order, as the reference's."""

    def forward(self, x):
        return x.reshape(x.shape[0], -1)

    def out_shape(self, s):
        return (s[0], int(np.prod(s[1:])))


class Linear(Layer):
    def __init__(self, fin: int, fout: int, bias: bool = True):
        super().__init__()
        self.fin, self.fout = fin, fout
        self.weight = nn.Parameter(torch.zeros(fout, fin))
        self.bias = nn.Parameter(torch.zeros(fout)) if bias else None

    def reset(self, generator):
        # drawn as the reference's (fin, fout) matrix, stored transposed
        w = torch.randn(self.fin, self.fout, generator=generator)
        with torch.no_grad():
            self.weight.copy_((w * (1.0 / math.sqrt(self.fin))).t())
            if self.bias is not None:
                self.bias.zero_()

    def load_reference(self, params):
        with torch.no_grad():
            _load(self.weight, np.transpose(params["w"]))
            if self.bias is not None:
                _load(self.bias, params["b"])

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def out_shape(self, s):
        return (*s[:-1], self.fout)

    def flops(self, s):
        return 2.0 * float(np.prod(s[:-1])) * self.fin * self.fout

    def param_count(self):
        return self.fin * self.fout + (self.fout if self.bias is not None else 0)


class Dropout(Layer):
    """Inference mode: identity (kept as a block to match torchvision
    children counts — the paper's block indices include them)."""

    def __init__(self, p: float = 0.5):
        super().__init__()
        self.p = p


class Sequential(Layer):
    def __init__(self, layers: Sequence[Layer] = ()):
        super().__init__()
        self.layers = nn.ModuleList(layers)

    def reset(self, generator):
        for l in self.layers:
            l.reset(generator)

    def load_reference(self, params):
        for l, p in zip(self.layers, params, strict=True):
            l.load_reference(p)

    def forward(self, x):
        for l in self.layers:
            x = l(x)
        return x

    def out_shape(self, s):
        for l in self.layers:
            s = l.out_shape(s)
        return s

    def flops(self, s):
        t = 0.0
        for l in self.layers:
            t += l.flops(s)
            s = l.out_shape(s)
        return t

    def eff_flops(self, s):
        t = 0.0
        for l in self.layers:
            t += l.eff_flops(s)
            s = l.out_shape(s)
        return t

    def param_count(self):
        return sum(l.param_count() for l in self.layers)


def conv_bn_relu(cin, cout, kernel, stride=1, padding=0, groups=1,
                 relu_cap=None) -> Sequential:
    return Sequential([
        Conv2D(cin, cout, kernel, stride, padding, groups, bias=False),
        BatchNorm(cout),
        ReLU(cap=relu_cap),
    ])


class Residual(Layer):
    """y = body(x) + shortcut(x), optional trailing ReLU (ResNet blocks)."""

    def __init__(self, body: Layer, shortcut: Layer | None = None,
                 post_relu: bool = True):
        super().__init__()
        self.body, self.shortcut, self.post_relu = body, shortcut, post_relu

    def reset(self, generator):
        self.body.reset(generator)
        if self.shortcut is not None:
            self.shortcut.reset(generator)

    def load_reference(self, params):
        self.body.load_reference(params["body"])
        if self.shortcut is not None:
            self.shortcut.load_reference(params["short"])

    def forward(self, x):
        y = self.body(x)
        y = y + (self.shortcut(x) if self.shortcut is not None else x)
        return y.clamp(min=0.0) if self.post_relu else y

    def out_shape(self, s):
        return self.body.out_shape(s)

    def flops(self, s):
        f = self.body.flops(s) + float(np.prod(self.body.out_shape(s)))
        if self.shortcut is not None:
            f += self.shortcut.flops(s)
        return f

    def eff_flops(self, s):
        f = self.body.eff_flops(s) + float(np.prod(self.body.out_shape(s)))
        if self.shortcut is not None:
            f += self.shortcut.eff_flops(s)
        return f

    def param_count(self):
        return self.body.param_count() + (
            self.shortcut.param_count() if self.shortcut is not None else 0)


class Parallel(Layer):
    """Concat of branches along channels (Inception mixed blocks)."""

    def __init__(self, branches: Sequence[Layer] = ()):
        super().__init__()
        self.branches = nn.ModuleList(branches)

    def reset(self, generator):
        for b in self.branches:
            b.reset(generator)

    def load_reference(self, params):
        for b, p in zip(self.branches, params, strict=True):
            b.load_reference(p)

    def forward(self, x):
        return torch.cat([b(x) for b in self.branches], dim=-1)

    def out_shape(self, s):
        shapes = [b.out_shape(s) for b in self.branches]
        c = sum(sh[-1] for sh in shapes)
        return (*shapes[0][:-1], c)

    def flops(self, s):
        return sum(b.flops(s) for b in self.branches)

    def eff_flops(self, s):
        return sum(b.eff_flops(s) for b in self.branches)

    def param_count(self):
        return sum(b.param_count() for b in self.branches)
