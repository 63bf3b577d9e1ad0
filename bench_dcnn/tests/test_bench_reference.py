"""The reference's layers against PyTorch's own convolutions and an
explicit sum over taps, at tiny sizes; its controls round their
operands."""

import itertools

import pytest
import torch
import torch.nn.functional as F

from bench_dcnn.reference import layers as L
from bench_dcnn.reference import numerics


def _taps_conv(x, w, stride, padding):
    """y[n, o, co] = sum_{k, ci} x[n, o*s + k - lo, ci] w[k, ci, co]."""
    rank = x.dim() - 2
    kern = w.shape[:rank]
    out = L.out_spatial("conv", x.shape[1:-1], kern, stride, padding)
    y = torch.zeros((x.shape[0], *out, w.shape[-1]), dtype=torch.float64)
    for o in itertools.product(*(range(n) for n in out)):
        for k in itertools.product(*(range(n) for n in kern)):
            i = [oo * s + kk - lo for oo, kk, s, (lo, _)
                 in zip(o, k, stride, padding)]
            if all(0 <= ii < n for ii, n in zip(i, x.shape[1:-1])):
                y[(slice(None), *o)] += x[(slice(None), *i)].double() \
                    @ w[k].double()
    return y


def _taps_deconv(x, w, stride, crop):
    """y[n, i*s + k - lo, co] += x[n, i, ci] w[k, ci, co], cropped."""
    rank = x.dim() - 2
    kern = w.shape[:rank]
    out = L.out_spatial("deconv", x.shape[1:-1], kern, stride, crop)
    y = torch.zeros((x.shape[0], *out, w.shape[-1]), dtype=torch.float64)
    for i in itertools.product(*(range(n) for n in x.shape[1:-1])):
        for k in itertools.product(*(range(n) for n in kern)):
            o = [ii * s + kk - lo for ii, kk, s, (lo, _)
                 in zip(i, k, stride, crop)]
            if all(0 <= oo < n for oo, n in zip(o, out)):
                y[(slice(None), *o)] += x[(slice(None), *i)].double() \
                    @ w[k].double()
    return y


@pytest.mark.parametrize("rank,stride,padding", [
    (2, (2, 2), ((1, 1), (1, 1))),
    (3, (1, 1, 1), ((1, 1),) * 3),
    (3, (2, 2, 2), ((1, 1),) * 3),
    (3, (1, 1, 1), ((0, 0),) * 3),
])
def test_conv_matches_taps_and_torch(rank, stride, padding):
    g = torch.Generator().manual_seed(rank)
    x = torch.randn((2, *([6] * rank), 3), generator=g)
    k = 1 if padding[0] == (0, 0) else 3
    w = torch.randn((*([k] * rank), 3, 4), generator=g)
    y = L.conv(x, w, stride, padding)
    torch.testing.assert_close(y.double(), _taps_conv(x, w, stride, padding),
                               rtol=1e-5, atol=1e-5)
    conv = {2: F.conv2d, 3: F.conv3d}[rank]
    want = conv(x.movedim(-1, 1), w.permute(rank + 1, rank, *range(rank)),
                stride=stride, padding=padding[0][0]).movedim(1, -1)
    torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("rank", [2, 3])
def test_deconv_matches_taps_and_torch(rank):
    g = torch.Generator().manual_seed(10 + rank)
    x = torch.randn((2, *([4] * rank), 3), generator=g)
    w = torch.randn((*([3] * rank), 3, 5), generator=g)
    stride, crop = (2,) * rank, ((0, 1),) * rank
    y = L.deconv(x, w, stride, crop)
    assert y.shape[1:-1] == (8,) * rank
    torch.testing.assert_close(y.double(), _taps_deconv(x, w, stride, crop),
                               rtol=1e-5, atol=1e-5)
    convt = {2: F.conv_transpose2d, 3: F.conv_transpose3d}[rank]
    full = convt(x.movedim(-1, 1), w.permute(rank, rank + 1, *range(rank)),
                 stride=2, output_padding=0).movedim(1, -1)
    torch.testing.assert_close(y, full[(slice(None), *([slice(0, 8)] * rank))],
                               rtol=1e-5, atol=1e-5)


def test_controls_round_their_operands():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(4096, generator=g) * 3
    t = numerics.operand(x, "tf32")
    assert torch.all((t.view(torch.int32) & 0x1FFF) == 0)
    assert 0 < float((t - x).abs().max() / x.abs().max()) < 2 ** -10
    e = float((numerics.operand(x, "fp8") - x).norm() / x.norm())
    assert 0.01 < e < 0.05
    assert torch.equal(numerics.operand(x, "f32"), x)


def test_tf32_backward_rounds_the_incoming_gradient():
    g = torch.Generator().manual_seed(1)
    x = torch.randn((1, 5, 5, 2), generator=g, requires_grad=True)
    w = torch.randn((3, 3, 2, 2), generator=g)
    y = L.conv(x, w, (1, 1), ((1, 1), (1, 1)), "tf32")
    up = torch.randn(y.shape, generator=g)
    (gx,) = torch.autograd.grad((y * up).sum(), x)
    xr = numerics.operand(x.detach(), "tf32")
    wr = numerics.operand(w, "tf32")
    xr.requires_grad_(True)
    y2 = L.conv(xr, wr, (1, 1), ((1, 1), (1, 1)))
    (want,) = torch.autograd.grad(y2, xr, numerics.operand(up, "tf32"))
    torch.testing.assert_close(gx, want)
