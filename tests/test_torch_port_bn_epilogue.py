"""The frozen-BN epilogue's CPU side (``kernels/bn_epilogue.py``): its plain
version against the eager expressions it takes the place of, bit for bit at
fp32, in each form; the towers with gradients off (each BN in the epilogue)
against the same modules with gradients on (PyTorch's passes), bit for bit;
the ``bn_fused`` / ``bn_eager`` counters in both modes; and what the
kernel's wrapper refuses. The kernel itself is held to the plain version on
the card (``tests/test_torch_port_cuda.py``)."""
import pytest
import torch

from gaussianformer_tpu_torch.kernels import bn_epilogue as epi
from gaussianformer_tpu_torch.models.backbone.resnet import (
    FrozenBatchNorm2d, ResNet)
from gaussianformer_tpu_torch.models.lifter.initializer import \
    ResNetSecondFPN
from gaussianformer_tpu_torch.models.segmentor import init_random_
from gaussianformer_tpu_torch.utils import profiling

DEPTH, BASE = 26, 8
DCN = (False, False, True, True)
# a ResNet-26's frozen BNs: the stem's, three a block and four downsamples'
TOWER_BNS = 1 + 4 * 3 + 4
# SECONDFPN's four branches
FPN_BNS = 4


def _randomize_bns(module, seed):
    """Statistics, scales and shifts away from the identity BN."""
    gen = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if isinstance(m, FrozenBatchNorm2d):
            c = m.weight.shape[0]
            with torch.no_grad():
                m.weight.copy_(torch.rand(c, generator=gen) + 0.5)
                m.bias.copy_(torch.randn(c, generator=gen))
                m.running_mean.copy_(torch.randn(c, generator=gen))
                m.running_var.copy_(torch.rand(c, generator=gen) * 2 + 0.1)
    return module


def _bn(c, seed, eps=1e-5):
    return _randomize_bns(FrozenBatchNorm2d(c, eps), seed)


@pytest.mark.parametrize("form", ["relu", "identity", "downsample"])
def test_plain_epilogue_is_the_eager_expression(form):
    gen = torch.Generator().manual_seed(0)
    a = torch.randn(2, 24, 5, 7, generator=gen) * 3
    b = torch.randn(2, 24, 5, 7, generator=gen) * 3
    bn_a, bn_b = _bn(24, 1), _bn(24, 2, eps=1e-3)
    if form == "relu":
        want = torch.relu(bn_a(a))
        got = epi.bn_epilogue_plain(a, bn_a.stats())
    elif form == "identity":
        want = torch.relu(bn_a(a) + b)
        got = epi.bn_epilogue_plain(a, bn_a.stats(), b)
    else:
        want = torch.relu(bn_a(a) + bn_b(b))
        got = epi.bn_epilogue_plain(a, bn_a.stats(), b, bn_b.stats())
    assert got.dtype == torch.float32
    assert torch.equal(got, want)
    assert (got == 0).any() and (got > 0).any()


def _towers():
    """The main tower's ResNet and the lifter's initializer tower, with the
    segmentor's seeded weights and BNs away from the identity."""
    towers = (ResNet(DEPTH, BASE, DCN),
              ResNetSecondFPN(DEPTH, DCN, BASE, (8, 8, 8, 8),
                              dtype=torch.float32))
    for seed, tower in enumerate(towers):
        with torch.no_grad():
            init_random_(tower, torch.Generator().manual_seed(seed))
        _randomize_bns(tower, seed + 3).eval()
    return towers


def test_towers_without_gradients_are_the_bits_with_them():
    imgs = torch.randn(2, 3, 64, 96, generator=torch.Generator()
                       .manual_seed(5))
    for tower in _towers():
        with torch.no_grad():
            fused = tower(imgs)
        eager = tower(imgs)
        fused = fused if isinstance(fused, tuple) else (fused,)
        eager = eager if isinstance(eager, tuple) else (eager,)
        assert len(fused) == len(eager)
        for f, e in zip(fused, eager):
            assert e.requires_grad and not f.requires_grad
            assert torch.equal(f, e.detach())


@pytest.mark.parametrize("grad", [False, True])
def test_bn_counters_in_both_modes(grad):
    """With gradients off every BN but the DCN blocks' bn2 (K1's epilogue)
    runs in the epilogue; with them on, every BN runs in PyTorch."""
    imgs = torch.randn(1, 3, 64, 96)
    n_dcn = sum(DCN)
    want = [(TOWER_BNS - n_dcn, 0), (TOWER_BNS - n_dcn + FPN_BNS, 0)]
    if grad:
        want = [(0, TOWER_BNS), (0, TOWER_BNS + FPN_BNS)]
    for tower, (fused, eager) in zip(_towers(), want):
        profiling.enable()
        with torch.set_grad_enabled(grad):
            tower(imgs)
        profiling.disable()
        got = profiling.collect()["counters"]
        assert got.get("bn_fused", 0) == fused
        assert got.get("bn_eager", 0) == eager


def _cl(t):
    return t.contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("case", ["dtype", "b_dtype", "layout", "channels",
                                  "shape", "bn_without_b", "stats",
                                  "device"])
def test_wrapper_refuses(case):
    a = _cl(torch.zeros(2, 16, 3, 5, dtype=torch.bfloat16))
    b = _cl(torch.zeros(2, 16, 3, 5, dtype=torch.bfloat16))
    bn, bn_b = _bn(16, 0).stats(), None
    if case == "dtype":
        a = a.float()
    elif case == "b_dtype":
        b = b.float()
    elif case == "layout":
        a = a.contiguous()
    elif case == "channels":
        a = _cl(torch.zeros(2, 12, 3, 5, dtype=torch.bfloat16))
        bn = _bn(12, 0).stats()
    elif case == "shape":
        b = _cl(torch.zeros(2, 16, 3, 4, dtype=torch.bfloat16))
    elif case == "bn_without_b":
        b, bn_b = None, bn
    elif case == "stats":
        bn = _bn(8, 0).stats()
    match = {"dtype": "dtype", "b_dtype": "dtype", "layout": "channels_last",
             "channels": "C % 8", "shape": "shape", "bn_without_b": "needs b",
             "stats": "statistics", "device": "CUDA tensor"}[case]
    with pytest.raises(ValueError, match=match):
        epi.bn_epilogue_cuda(a, bn, b, bn_b)


def test_applies_follows_grad_mode_device_and_dtype():
    x = torch.zeros(1, 8, 2, 2)
    assert not epi.applies(x)
    with torch.no_grad():
        assert epi.applies(x) and epi.applies(x.bfloat16())
    with torch.inference_mode():
        assert epi.applies(x)
