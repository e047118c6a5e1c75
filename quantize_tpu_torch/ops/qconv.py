"""W8A8 conv2d on the int8 path: kernel K3, the z_a correction map and the
space-to-depth stem rewrite; and the weight-only conv (a dequantized weight
and one float32 conv).

PyTorch counterpart of ``quantize_tpu/ops/qconv.py``. The JAX package lowers
the int8 conv through XLA (``conv_general_dilated(int8, int8) -> int32``);
stock PyTorch has no CUDA int8 convolution, so :func:`qconv2d_int8` launches
the hand-written implicit-GEMM kernel ``csrc/qconv2d.cu`` on CUDA tensors
and runs :func:`qconv2d_int8_plain` on CPU tensors. Layouts are NHWC
activations and HWIO kernels, as in JAX. The kernel (8-bit ``wgmma``) reads
the weight as a K-major copy (:func:`kmajor_weight`), which a packed
:class:`~quantize_tpu_torch.nn.layers.QuantConv` makes once, when its weight
is packed or loaded, and keeps outside the packed variables; it takes Ci in
multiples of 16: the wrapper zero-pads fewer channels (the space-to-depth
stem's 12, ViT's patch embedding's 3), which adds nothing to the sums.

The int8 conv pads with q = 0, but a padded position must contribute zero
to the float result while a real q = 0 position contributes ``z_a·s_a·ŵ``;
the border-exact correction ``z_a·Σ_valid w`` is the pack-time map
:func:`conv_zero_correction_map`:

    out = s_a·s_w·( conv(q_a, q_w) + z_a·conv(mask, Σ_ci q_w)
                    + z_w·conv(q_a, 1) + z_a·z_w·conv(mask, 1) ) + bias
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from . import _build
from .qmatmul import _dequant_weight, quantize_act_int8

Padding = Union[str, Sequence[Tuple[int, int]]]


def resolve_padding(padding: Padding, kh: int, kw: int, h: int, w: int,
                    strides: Sequence[int]) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """Explicit ((top, bottom), (left, right)) padding with JAX semantics
    (``"SAME"`` puts the odd pixel at the end)."""
    if isinstance(padding, str):
        mode = padding.upper()
        if mode == "VALID":
            return (0, 0), (0, 0)
        if mode != "SAME":
            raise ValueError(f"unknown padding {padding!r}")
        pads = []
        for size, k, s in ((h, kh, strides[0]), (w, kw, strides[1])):
            total = max((-(-size // s) - 1) * s + k - size, 0)
            pads.append((total // 2, total - total // 2))
        return tuple(pads[0]), tuple(pads[1])
    (pt, pb), (pl, pr) = padding
    return (int(pt), int(pb)), (int(pl), int(pr))


def conv_nhwc(x: torch.Tensor, w: torch.Tensor, strides: Sequence[int],
              padding: Padding, groups: int = 1) -> torch.Tensor:
    """Float conv over NHWC input and HWIO kernel (layouts converted inside)."""
    kh, kw = w.shape[:2]
    (pt, pb), (pl, pr) = resolve_padding(padding, kh, kw, x.shape[1], x.shape[2], strides)
    xc = x.permute(0, 3, 1, 2)
    if (pt, pl) == (pb, pr):
        pad = (pt, pl)
    else:
        xc = F.pad(xc, (pl, pr, pt, pb))
        pad = (0, 0)
    out = F.conv2d(xc, w.permute(3, 2, 0, 1), stride=tuple(strides), padding=pad,
                   groups=groups)
    return out.permute(0, 2, 3, 1)


def conv_zero_correction_map(w_int: torch.Tensor, h: int, w_sp: int,
                             strides: Sequence[int] = (1, 1),
                             padding: Padding = "SAME") -> torch.Tensor:
    """The z_a correction map ``conv(mask, Σ_ci w)``, (1, H', W', co) f32.

    Depends only on the packed weight and the input spatial size, so it is
    computed once at pack time. Summed in float64: the values are integers
    and stay exact whatever the device's float32 conv precision.
    """
    mask = torch.ones((1, h, w_sp, 1), dtype=torch.float64, device=w_int.device)
    w_ci_sum = w_int.double().sum(dim=2, keepdim=True)
    return conv_nhwc(mask, w_ci_sum, strides, padding).float().contiguous()


def int8_conv_exact(q_a: torch.Tensor, w_int: torch.Tensor, strides: Sequence[int],
                    pads) -> torch.Tensor:
    """int8 NHWC x int8 HWIO conv summed exactly, as float64 (zero padding,
    as the int8 conv pads). Works on any device."""
    return conv_nhwc(q_a.double(), w_int.double(), strides, pads)


def qconv2d_int8_plain(q_a: torch.Tensor, z_eff: torch.Tensor, a_scale: torch.Tensor,
                       w_int: torch.Tensor, w_scale: torch.Tensor, w_zero: torch.Tensor,
                       bias: Optional[torch.Tensor], strides: Sequence[int],
                       pads, corr_a: torch.Tensor, w_zero_is_zero: bool,
                       out_dtype: torch.dtype,
                       w_km: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of kernel K3 (integer sums exact in float64), with the
    epilogue in the order of ``quantize_tpu/ops/qconv.py:quant_conv2d``.
    ``w_km``, the kernel's own copy of the weight, is not read."""
    acc = int8_conv_exact(q_a, w_int, strides, pads).float()
    corrected = acc + z_eff * corr_a
    if not w_zero_is_zero:
        kh, kw, ci, _ = w_int.shape
        n, h, w_sp, _ = q_a.shape
        ones_k = torch.ones((kh, kw, ci, 1), dtype=torch.float64, device=q_a.device)
        row_sum = conv_nhwc(q_a.double(), ones_k, strides, pads).float()
        mask = torch.ones((1, h, w_sp, 1), dtype=torch.float64, device=q_a.device)
        taps = torch.ones((kh, kw, 1, 1), dtype=torch.float64, device=q_a.device)
        count = conv_nhwc(mask, taps, strides, pads).float() * ci
        wz = w_zero.reshape(1, 1, 1, -1)
        corrected = corrected + wz * row_sum + z_eff * wz * count
    out = a_scale * w_scale.reshape(1, 1, 1, -1) * corrected
    if bias is not None:
        out = out + bias
    return out.to(out_dtype)


def kmajor_weight(w_int: torch.Tensor) -> torch.Tensor:
    """The (Co, KH*KW*Ci') K-major copy of an HWIO int8 kernel, the layout
    8-bit ``wgmma`` reads: row co holds ``w_int[..., co]`` flattened in
    (kh, kw, ci) order, with Ci zero-padded to Ci', the next multiple of 16."""
    kh, kw, ci, co = w_int.shape
    ci_pad = -(-ci // 16) * 16
    return F.pad(w_int, (0, 0, 0, ci_pad - ci)).reshape(kh * kw * ci_pad, co).t().contiguous()


def qconv2d_int8(q_a: torch.Tensor, z_eff: torch.Tensor, a_scale: torch.Tensor,
                 w_int: torch.Tensor, w_scale: torch.Tensor, w_zero: torch.Tensor,
                 bias: Optional[torch.Tensor], strides: Sequence[int], pads,
                 corr_a: torch.Tensor, w_zero_is_zero: bool,
                 out_dtype: torch.dtype,
                 w_km: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel K3: int8 NHWC ``q_a`` (N, H, W, Ci) conv int8 HWIO ``w_int``
    with explicit ``pads`` ((top, bottom), (left, right)) and the W8A8
    epilogue; ``corr_a`` is the (1, H', W', Co) f32 correction map.
    ``w_km`` is ``kmajor_weight(w_int)`` made beforehand (made here when
    None). Returns (N, H', W', Co) in ``out_dtype``."""
    dev = q_a.device
    if dev.type == "cpu":
        return qconv2d_int8_plain(q_a, z_eff, a_scale, w_int, w_scale, w_zero, bias,
                                  strides, pads, corr_a, w_zero_is_zero, out_dtype)
    if dev.type != "cuda":
        raise ValueError(f"qconv2d_int8: unsupported device {dev}")
    n, h, w_sp, ci = q_a.shape
    kh, kw, _, co = w_int.shape
    (pt, pb), (pl, pr) = pads
    sh, sw = strides
    oh = (h + pt + pb - kh) // sh + 1
    ow = (w_sp + pl + pr - kw) // sw + 1
    _build.require(q_a, "q_a", dev, torch.int8)
    _build.require(w_int, "w_int", dev, torch.int8, (kh, kw, ci, co))
    _build.require(corr_a, "corr_a", dev, torch.float32, (1, oh, ow, co))
    for name, t in (("w_scale", w_scale), ("w_zero", w_zero)):
        _build.require(t, name, dev, torch.float32, (co,))
    if bias is not None:
        _build.require(bias, "bias", dev, torch.float32, (co,))
    _build.require(a_scale, "a_scale", dev, torch.float32, ())
    _build.require(z_eff, "z_eff", dev, torch.float32, ())
    out_code = _build.dtype_code(out_dtype)
    ci_pad = -(-ci // 16) * 16
    if w_km is None:
        w_km = kmajor_weight(w_int)
    _build.require(w_km, "w_km", dev, torch.int8, (co, kh * kw * ci_pad))
    out = torch.empty((n, oh, ow, co), dtype=out_dtype, device=dev)
    # zero channels up to a multiple of 16: the kernel gathers 16-byte pieces
    # of one tap; the z_w terms count the real ci
    x = F.pad(q_a, (0, ci_pad - ci)) if ci_pad != ci else q_a
    fn = _build.kernel_fn("qconv2d")
    with torch.cuda.device(dev):
        err = fn(_build.ptr(x), _build.ptr(w_km), _build.ptr(corr_a),
                 _build.ptr(w_scale), _build.ptr(w_zero), _build.ptr(bias),
                 _build.ptr(a_scale), _build.ptr(z_eff), _build.ptr(out),
                 n, h, w_sp, ci_pad, oh, ow, co, kh, kw, sh, sw, pt, pl, ci,
                 int(bool(w_zero_is_zero)), out_code, _build.current_stream(dev))
    _build.check(err, "qconv2d")
    qconv2d_int8.launches += 1
    return out


qconv2d_int8.launches = 0


def quant_conv2d(
    x: torch.Tensor,
    a_scale,
    a_zero,
    a_qmin: int,
    a_qmax: int,
    w_int: torch.Tensor,  # (kh, kw, ci/groups, co) int8
    w_scale: torch.Tensor,  # (co,)
    w_zero: torch.Tensor,  # (co,)
    bias: Optional[torch.Tensor] = None,
    strides: Sequence[int] = (1, 1),
    padding: Padding = "SAME",
    groups: int = 1,
    w_zero_is_zero: bool = False,
    corr_a: Optional[torch.Tensor] = None,
    pre_q: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    out_dtype: Optional[torch.dtype] = None,
    w_km: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Fused W8A8 conv2d (per-out-channel weight scales, per-tensor act).

    ``pre_q``: the already-quantized input ``(q_int8, z_eff)`` (``x`` is
    then only read for its shape). ``out_dtype``: the dtype of the result
    (the epilogue stays f32). ``w_km``: ``kmajor_weight(w_int)``, made once
    by the caller that holds the weight.
    """
    if groups != 1:
        raise NotImplementedError(
            "quant_conv2d: grouped int8 conv (ResNeXt) is not ported to "
            "quantize_tpu_torch yet; see ROADMAP.md")
    n, h, w_sp, _ = x.shape
    if pre_q is not None:
        q_a, z_eff = pre_q
    else:
        q_a, z_eff = quantize_act_int8(x, a_scale, a_zero, a_qmin, a_qmax)
    kh, kw = w_int.shape[:2]
    pads = resolve_padding(padding, kh, kw, h, w_sp, strides)
    oh = (h + pads[0][0] + pads[0][1] - kh) // strides[0] + 1
    ow = (w_sp + pads[1][0] + pads[1][1] - kw) // strides[1] + 1
    if corr_a is None or tuple(corr_a.shape[1:3]) != (oh, ow):
        corr_a = conv_zero_correction_map(w_int, h, w_sp, strides, pads)
    dev = q_a.device
    out = qconv2d_int8(
        q_a.contiguous(),
        torch.as_tensor(z_eff, dtype=torch.float32, device=dev).reshape(()),
        torch.as_tensor(a_scale, dtype=torch.float32, device=dev).reshape(()),
        w_int.contiguous(), w_scale.float().reshape(-1), w_zero.float().reshape(-1),
        None if bias is None else bias.float(), tuple(strides), pads,
        corr_a.float().contiguous(), w_zero_is_zero,
        torch.float32 if out_dtype is None else out_dtype, w_km)
    return out


def quant_conv2d_wo(
    x: torch.Tensor,
    w_int: torch.Tensor,  # (kh, kw, ci, co) int8
    w_scale: torch.Tensor,  # (co,)
    w_zero: torch.Tensor,  # (co,)
    bias: Optional[torch.Tensor] = None,
    strides: Sequence[int] = (1, 1),
    padding: Padding = "SAME",
    groups: int = 1,
    awq_recip: Optional[torch.Tensor] = None,
    group_size: int = 0,
) -> torch.Tensor:
    """Weight-only-quantized conv (JAX ``qconv.py:127-168``): the weight
    dequantized, ``(w + z)·s`` in float32, then one float32 conv and
    ``+ bias``. JAX computes this in XLA outside any Pallas kernel, so the
    conv is the library's (TF32 off on the card keeps it float32).

    AWQ deploy: the packed kernel stores Q(w·awq); ``awq_recip`` (C_in,)
    folds the 1/awq in-channel divisor into the dequantized kernel.
    ``group_size`` > 0 selects the ``q_group_size`` grid of the 2-D
    (kh*kw*ci, co) weight, as the quantizer packed it
    (:func:`~quantize_tpu_torch.quant.observers.group_view`)."""
    w_deq = _dequant_weight(w_int.reshape(-1, w_int.shape[-1]), w_scale, w_zero,
                            group_size=group_size).reshape(w_int.shape)
    if awq_recip is not None:
        # the in-channel axis of HWIO is -2
        w_deq = w_deq * awq_recip.float().reshape(-1, 1)
    out = conv_nhwc(x.float(), w_deq, strides, padding, groups)
    return out if bias is None else out + bias


# ---------------------------------------------------------------------------
# Space-to-depth stem transform (packed inference): a stride-2 KxK conv on
# few input channels rewritten as a stride-1 ceil(K/2)^2 conv over a 2x2
# space-to-depth input; exact whenever stride == 2, (pad_before + kernel
# pad) is even and the weight zero points are zero.
# ---------------------------------------------------------------------------

def space_to_depth(x: torch.Tensor, s: int = 2) -> torch.Tensor:
    """(N, H, W, C) -> (N, H/s, W/s, s*s*C); channel index (dy, dx, c)."""
    n, h, w, c = x.shape
    x = x.reshape(n, h // s, s, w // s, s, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h // s, w // s, s * s * c)


def s2d_kernel(w: torch.Tensor, s: int = 2) -> torch.Tensor:
    """(kh, kw, ci, co) -> (ceil(kh/s), ceil(kw/s), s*s*ci, co) with zero
    pre-padding; channel order matches :func:`space_to_depth`."""
    kh, kw, ci, co = w.shape
    ph, pw = (-kh) % s, (-kw) % s
    w = F.pad(w, (0, 0, 0, 0, pw, 0, ph, 0))
    kb_h, kb_w = (kh + ph) // s, (kw + pw) // s
    w = w.reshape(kb_h, s, kb_w, s, ci, co)
    w = w.permute(0, 2, 1, 3, 4, 5)
    return w.reshape(kb_h, kb_w, s * s * ci, co)


def s2d_block_padding(kh: int, kw: int, pad, h: int, w: int, s: int = 2):
    """Block-space explicit padding equivalent to ``pad`` on the original
    stride-``s`` conv (kernel pre-padded per :func:`s2d_kernel`); None when
    no exact block mapping exists."""
    (pht, phb), (pwt, pwb) = pad
    ph, pw = (-kh) % s, (-kw) % s
    if (pht + ph) % s or (pwt + pw) % s or h % s or w % s:
        return None
    out_h = (h + pht + phb - kh) // s + 1
    out_w = (w + pwt + pwb - kw) // s + 1
    pb_h, pb_w = (pht + ph) // s, (pwt + pw) // s
    kb_h, kb_w = (kh + ph) // s, (kw + pw) // s
    pa_h = max(0, (out_h - 1) - pb_h + kb_h - h // s)
    pa_w = max(0, (out_w - 1) - pb_w + kb_w - w // s)
    return [(pb_h, pa_h), (pb_w, pa_w)]
