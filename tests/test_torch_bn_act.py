"""The frozen BatchNorm + residual + ReLU op (`ops/bn_act_cuda.py`) on the
CPU: its plain version against the composition it replaces
(`FrozenBatchNorm`, then `+ residual`, then `F.relu`), and the ResNet-C4
head and tail that call it against a copy of the bottleneck as it was
written before the op, bit for bit in outputs and gradients. The kernels
themselves are compared with the plain version on the card
(`tests/test_torch_cuda.py`)."""

import pytest
import torch
import torch.nn.functional as F

from lang2seg_tpu_torch.ops import bn_act_cuda
from lang2seg_tpu_torch.ops.bn_act_cuda import bn_act, bn_act_plain
from lang2seg_tpu_torch.models.resnet import FrozenBatchNorm, ResNetC4
from lang2seg_tpu_torch.tools.profile_bn_act import random_bn, same_bits

VARIANTS = ("relu", "residual", "down")
DTYPES = (torch.bfloat16, torch.float32)


def activation(shape, dtype, g):
    return (torch.randn(shape, generator=g) * 3).to(
        dtype, memory_format=torch.channels_last).requires_grad_(True)


def composition(x, bn, variant, other, bn_d):
    """The ops the bottleneck ran before `bn_act`."""
    y = bn(x)
    if variant == "residual":
        y = y + other
    elif variant == "down":
        y = y + bn_d(other)
    return F.relu(y)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("variant", VARIANTS)
def test_plain_equals_the_composition(variant, dtype):
    g = torch.Generator().manual_seed(VARIANTS.index(variant))
    shape = (3, 16, 5, 7)
    bn, bn_d = random_bn(16, g, "cpu"), random_bn(16, g, "cpu")
    grad = torch.randn(shape, generator=g).to(dtype)
    results = []
    for fn in ("composition", "plain", "bn_act"):
        x = activation(shape, dtype, torch.Generator().manual_seed(7))
        other = activation(shape, dtype, torch.Generator().manual_seed(8))
        if fn == "composition":
            out = composition(x, bn, variant, other, bn_d)
        else:
            op = bn_act_plain if fn == "plain" else bn_act
            kw = {"relu": {}, "residual": {"residual": other},
                  "down": {"down": (other, bn_d)}}[variant]
            out = op(x, bn, **kw)
        out.backward(grad)
        results.append((out.detach(), x.grad,
                        None if variant == "relu" else other.grad))
    ref = results[0]
    assert bool((ref[0] == 0).any()) and bool((ref[0] > 0).any())
    for got in results[1:]:
        for a, b in zip(got, ref):
            assert (a is None and b is None) or same_bits(a, b)


def _old_block(blk, x):
    """`Bottleneck.forward` as it was written before `bn_act`."""
    residual = x if blk.downsample is None else blk.downsample(x)
    out = F.relu(blk.bn1(blk.conv1(x)))
    out = F.relu(blk.bn2(blk.conv2(out)))
    out = blk.bn3(blk.conv3(out))
    return F.relu(out + residual)


def _old_head(net, images):
    x = images.permute(0, 3, 1, 2).to(net.dtype,
                                      memory_format=torch.channels_last)
    x = F.relu(net.bn1(net.conv1(x)))
    x = F.max_pool2d(x, 3, stride=2, padding=1)
    for layer in (net.layer1, net.layer2, net.layer3):
        for blk in layer:
            x = _old_block(blk, x)
    return x.permute(0, 2, 3, 1)


def _old_tail(net, pool5):
    x = pool5.permute(0, 3, 1, 2).to(net.dtype,
                                     memory_format=torch.channels_last)
    for blk in net.layer4:
        x = _old_block(blk, x)
    return x.permute(0, 2, 3, 1)


def _tiny_resnet(dtype):
    torch.manual_seed(0)
    net = ResNetC4("resnet26", dtype=dtype)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for mod in net.modules():
            if isinstance(mod, FrozenBatchNorm):
                fresh = random_bn(mod.weight.numel(), g, "cpu")
                for name, buf in fresh.named_buffers():
                    getattr(mod, name).copy_(buf * (0.5 if name == "weight"
                                                    else 1.0))
    return net


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("part", ["head", "tail"])
def test_resnet_equals_the_old_bottleneck(part, dtype):
    """Outputs, input gradients and every parameter's gradient of the tiny
    ResNet-C4's head (from images) or tail (from crops), bit for bit."""
    net = _tiny_resnet(dtype)
    g = torch.Generator().manual_seed(2)
    if part == "head":
        inp = torch.randn((1, 48, 64, 3), generator=g) * 40
        new, old = net.head, lambda t: _old_head(net, t)
    else:
        inp = torch.randn((3, 7, 7, 1024), generator=g).to(dtype)
        new, old = net.tail, lambda t: _old_tail(net, t)
    results = []
    for fn in (new, old):
        net.zero_grad(set_to_none=True)
        x = inp.clone().requires_grad_(True)
        out = fn(x)
        up = torch.randn(out.shape, generator=torch.Generator()
                         .manual_seed(3)).to(out.dtype)
        out.backward(up)
        results.append([out.detach(), x.grad] + [
            p.grad for p in net.parameters() if p.grad is not None])
    assert len(results[0]) == len(results[1]) > 2
    for a, b in zip(*results):
        assert same_bits(a, b)


def test_frozen_bn_state_dict_keys_unchanged():
    """The buffers keep the reference's BatchNorm2d names, and the
    downsample branch stays `downsample.0` (conv) / `downsample.1` (BN)."""
    keys = set(ResNetC4("resnet26").state_dict())
    for bn in ("bn1", "layer1.0.bn1", "layer1.0.bn3",
               "layer1.0.downsample.1", "layer4.0.bn2"):
        for buf in ("weight", "bias", "running_mean", "running_var"):
            assert f"{bn}.{buf}" in keys
    assert "layer1.0.downsample.0.weight" in keys
    assert not any("num_batches_tracked" in k for k in keys)


@pytest.mark.parametrize("fn", ["launch_forward", "launch_backward"])
def test_launches_refuse_cpu_tensors(fn):
    """The kernels' entries take CUDA tensors only (no fallback)."""
    x = torch.zeros((1, 8, 2, 2)).to(memory_format=torch.channels_last)
    args = (x, FrozenBatchNorm(8)) if fn == "launch_forward" else \
        (x, x, FrozenBatchNorm(8))
    with pytest.raises(ValueError, match="CUDA tensor"):
        getattr(bn_act_cuda, fn)(*args)

