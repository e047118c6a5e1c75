"""W8A8 conv2d on the int8 path: kernel K3 (``groups == 1``), kernel K3g
(the grouped conv), the z_a correction map and the space-to-depth stem
rewrite; and the weight-only conv (a dequantized weight and one float32
conv).

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
A grouped conv (``groups > 1``, ResNeXt) launches :func:`qconv2d_grouped_int8`,
``csrc/qconv2d_grouped.cu``, on one of two routes chosen from the shape
(:func:`_grouped_route`): a tensor-core implicit GEMM over block-diagonal
slices of 32 (or 64) channels where Ci/G == Co/G is 4-64 (every ResNeXt of
the model zoo), over its block-diagonal K-major copy of the weight
(:func:`blockdiag_weight`), else a CUDA-core ``__dp4a`` kernel over its word
copy (:func:`grouped_weight`); :func:`grouped_kernel_weight` makes the copy
a shape's route reads. CPU tensors run :func:`qconv2d_grouped_int8_plain`.

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

from . import _build, _cost
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


def conv_args(strides: Sequence[int], pads) -> Tuple[int, ...]:
    """K3's and K3g's ``strides`` and ``pads`` as the six ints of their
    ``qtt`` ops (:mod:`.library`): sh, sw, pt, pb, pl, pr."""
    (pt, pb), (pl, pr) = pads
    return int(strides[0]), int(strides[1]), int(pt), int(pb), int(pl), int(pr)


def kmajor_weight(w_int: torch.Tensor) -> torch.Tensor:
    """The (Co, KH*KW*Ci') K-major copy of an HWIO int8 kernel, the layout
    8-bit ``wgmma`` reads: row co holds ``w_int[..., co]`` flattened in
    (kh, kw, ci) order, with Ci zero-padded to Ci', the next multiple of 16."""
    kh, kw, ci, co = w_int.shape
    ci_pad = -(-ci // 16) * 16
    return F.pad(w_int, (0, 0, 0, ci_pad - ci)).reshape(kh * kw * ci_pad, co).t().contiguous()


@_cost.reports("qconv2d")
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
    if torch.compiler.is_exporting():
        return torch.ops.qtt.qconv2d(q_a, z_eff, a_scale, w_int, w_scale, w_zero, bias,
                                     *conv_args(strides, pads), corr_a, bool(w_zero_is_zero),
                                     out_dtype, w_km)
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
    with _build.device_guard(dev):
        err = fn(_build.ptr(x), _build.ptr(w_km), _build.ptr(corr_a),
                 _build.ptr(w_scale), _build.ptr(w_zero), _build.ptr(bias),
                 _build.ptr(a_scale), _build.ptr(z_eff), _build.ptr(out),
                 n, h, w_sp, ci_pad, oh, ow, co, kh, kw, sh, sw, pt, pl, ci,
                 int(bool(w_zero_is_zero)), out_code, _build.current_stream(dev))
    _build.check(err, "qconv2d")
    qconv2d_int8.launches += 1
    return out


qconv2d_int8.launches = 0


# K3g's dp4a route (``csrc/qconv2d_grouped.cu``): a block of 256 threads
# covers bp output pixels and up to 64 output channels (whole groups where a
# group has at most 64, else 64 channels of one group), with the block's
# weights and its im2col patch rows staged in shared memory as 4-byte words
K3G_CHANNELS = 64
K3G_PIXELS = (64, 32, 16, 8, 4)
K3G_SMEM_TWO_BLOCKS = 113 * 1024  # two blocks an SM where it fits
K3G_SMEM_MAX = 232448  # what one block may have on an H100


def _grouped_tile(taps: int, cig: int, cog: int, groups: int) -> Tuple[int, int, int, int]:
    """K3g's tile for ``taps`` = KH*KW, ``cig``/``cog`` input/output
    channels a group: ``(gb, bp, cr, smem)``, the groups whose inputs a
    block stages, its output pixels, the output channels a thread sums (4,
    2 or 1, a divisor of ``cog``) and its shared memory in bytes, which
    mirrors ``csrc/qconv2d_grouped.cu: smem_bytes``. Raises ValueError for
    a shape whose smallest tile exceeds the card's shared memory."""
    cw = -(-cig // 4)
    if cog <= K3G_CHANNELS:
        gb = min(groups, K3G_CHANNELS // cog)
        cb = gb * cog
    else:
        gb, cb = 1, K3G_CHANNELS
    cr = 4 if cog % 4 == 0 else 2 if cog % 2 == 0 else 1

    def smem_bytes(bp):
        # weights (channels padded to 4), patch rows, per-pixel bases and
        # origins, s_w / bias / z_w of the block's channels
        return 4 * taps * cw * (-(-cb // 4) * 4) + 4 * taps * gb * cw * bp + 16 * bp + 12 * cb

    for limit in (K3G_SMEM_TWO_BLOCKS, K3G_SMEM_MAX):
        for bp in K3G_PIXELS:
            if smem_bytes(bp) <= limit:
                return gb, bp, cr, smem_bytes(bp)
    raise ValueError(
        f"qconv2d_grouped_int8: a {taps}-tap kernel with {cig} input channels a group needs "
        f"{smem_bytes(K3G_PIXELS[-1])} bytes of shared memory at its smallest tile, more "
        f"than the {K3G_SMEM_MAX} a block may have")


def grouped_weight(w_int: torch.Tensor, groups: int) -> torch.Tensor:
    """K3g's copy of an HWIO int8 kernel (kh, kw, Ci/G, Co): (G, KH*KW,
    ceil(Ci/G / 4), Co/G, 4) int8, read as 4-byte words: word (g, tap, w, j)
    holds input channels 4w .. 4w + 3 of group g (zeros past Ci/G) for output
    channel j of the group."""
    kh, kw, cig, co = w_int.shape
    cw = -(-cig // 4)
    w = w_int.reshape(kh * kw, cig, groups, co // groups)
    w = F.pad(w, (0, 0, 0, 0, 0, 4 * cw - cig)).reshape(kh * kw, cw, 4, groups, co // groups)
    return w.permute(3, 0, 1, 4, 2).contiguous()


# K3g's wgmma route (``csrc/qconv2d_grouped.cu``, namespace wgg): Ci/G ==
# Co/G of these widths; a block computes 128 output pixels by 64 output
# channels, slices of 32 channels (64 at Ci/G = 64) against a block-diagonal
# weight
K3G_WGMMA_WIDTHS = (4, 8, 16, 32, 64)
K3G_WGMMA_BN = 64


def _grouped_slice(cig: int) -> int:
    """The channels of one slice of K3g's wgmma route: 32 (whole groups of
    ``cig`` = Ci/G <= 32 channels) or one group of 64."""
    return max(32, cig)


def _grouped_route(taps: int, cig: int, cog: int, groups: int, aligned: bool = True) -> str:
    """Which kernel of ``csrc/qconv2d_grouped.cu`` takes a grouped conv of
    ``taps`` = KH*KW taps, ``cig``/``cog`` input/output channels a group
    and ``groups`` groups, chosen from the shape before launch: ``"wgmma"``
    where Ci/G == Co/G is one of 4, 8, 16, 32 and 64, the C = G * Ci/G
    channels are a multiple of 64 (a block's 64 output channels are whole
    slices), the K of a slice (``taps`` * its channels) is below 2^17 (int32
    sums of at most 2^14 a product cannot overflow) and the activation and
    the weight copy are 16-byte ``aligned``; else ``"dp4a"``."""
    if (cig == cog and cig in K3G_WGMMA_WIDTHS and groups * cig % K3G_WGMMA_BN == 0
            and taps * _grouped_slice(cig) < 1 << 17 and aligned):
        return "wgmma"
    return "dp4a"


def blockdiag_weight(w_int: torch.Tensor, groups: int) -> torch.Tensor:
    """The wgmma route's copy of an HWIO int8 kernel (kh, kw, Ci/G, Co) with
    Ci/G == Co/G: (Co, KH*KW*NS) int8, K-major, NS = ``_grouped_slice(Ci/G)``.
    Row co holds, for each tap in (kh, kw) order, the NS input channels of
    co's slice (channels NS * (co // NS) ..): ``w_int[kh, kw, :, co]`` at
    co's group's place in the slice, zeros at the other groups' channels."""
    kh, kw, cig, co = w_int.shape
    ns, taps = _grouped_slice(cig), kh * kw
    w = w_int.reshape(taps, cig, co).permute(2, 0, 1)  # (Co, taps, Ci/G)
    # group g's channels start at g * Ci/G, at g * Ci/G mod NS in its slice
    start = (torch.arange(co, device=w_int.device) // (co // groups)) * cig % ns
    idx = (start.reshape(co, 1, 1) + torch.arange(cig, device=w_int.device)).expand(co, taps, cig)
    out = torch.zeros((co, taps, ns), dtype=torch.int8, device=w_int.device)
    return out.scatter_(2, idx, w).reshape(co, taps * ns)


def grouped_kernel_weight(w_int: torch.Tensor, groups: int) -> torch.Tensor:
    """The copy of an HWIO int8 kernel that the route of its shape reads
    (:func:`_grouped_route`): :func:`blockdiag_weight` for ``"wgmma"``,
    :func:`grouped_weight` for ``"dp4a"``. ``QuantConv`` makes it once, when
    its weight is packed or loaded."""
    kh, kw, cig, co = w_int.shape
    if _grouped_route(kh * kw, cig, co // groups, groups) == "wgmma":
        return blockdiag_weight(w_int, groups)
    return grouped_weight(w_int, groups)


def qconv2d_grouped_int8_plain(q_a: torch.Tensor, z_eff: torch.Tensor, a_scale: torch.Tensor,
                               w_int: torch.Tensor, w_scale: torch.Tensor,
                               w_zero: torch.Tensor, bias: Optional[torch.Tensor],
                               strides: Sequence[int], pads, corr_a: torch.Tensor,
                               w_zero_is_zero: bool, out_dtype: torch.dtype, groups: int,
                               w_g: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of kernel K3g: the grouped int8 conv summed exactly (in
    float64), then the epilogue of ``quantize_tpu/ops/qconv.py:quant_conv2d``
    in its order, with the z_w row sums taken over each group's own input
    channels (``:107-119``). ``w_g``, the kernel's own copy of the weight,
    is not read."""
    acc = conv_nhwc(q_a.double(), w_int.double(), strides, pads, groups).float()
    corrected = acc + z_eff * corr_a
    if not w_zero_is_zero:
        kh, kw, cig, co = w_int.shape
        n, h, w_sp, _ = q_a.shape
        ones_k = torch.ones((kh, kw, cig, groups), dtype=torch.float64, device=q_a.device)
        row_sum = conv_nhwc(q_a.double(), ones_k, strides, pads, groups).float()
        row_sum = row_sum.repeat_interleave(co // groups, dim=-1)
        mask = torch.ones((1, h, w_sp, 1), dtype=torch.float64, device=q_a.device)
        taps = torch.ones((kh, kw, 1, 1), dtype=torch.float64, device=q_a.device)
        count = conv_nhwc(mask, taps, strides, pads).float() * cig
        wz = w_zero.reshape(1, 1, 1, -1)
        corrected = corrected + wz * row_sum + z_eff * wz * count
    out = a_scale * w_scale.reshape(1, 1, 1, -1) * corrected
    if bias is not None:
        out = out + bias
    return out.to(out_dtype)


@_cost.reports("qconv2d_grouped")
def qconv2d_grouped_int8(q_a: torch.Tensor, z_eff: torch.Tensor, a_scale: torch.Tensor,
                         w_int: torch.Tensor, w_scale: torch.Tensor, w_zero: torch.Tensor,
                         bias: Optional[torch.Tensor], strides: Sequence[int], pads,
                         corr_a: torch.Tensor, w_zero_is_zero: bool, out_dtype: torch.dtype,
                         groups: int, w_g: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel K3g: int8 NHWC ``q_a`` (N, H, W, Ci) conv int8 HWIO ``w_int``
    (kh, kw, Ci/G, Co) in ``groups`` = G groups, with explicit ``pads`` and
    the W8A8 epilogue; ``corr_a`` is the (1, H', W', Co) f32 correction map,
    ``conv_zero_correction_map(w_int, H, W, strides, pads)``. Returns (N,
    H', W', Co) in ``out_dtype``.

    CPU tensors take :func:`qconv2d_grouped_int8_plain`; CUDA tensors launch
    one of the two kernels of ``csrc/qconv2d_grouped.cu``, chosen from the
    shape before launch (:func:`_grouped_route`; the launches of each are
    counted in ``qconv2d_grouped_int8.route_launches``), or raise. ``w_g`` is
    the copy that route reads, ``grouped_kernel_weight(w_int, groups)`` made
    beforehand; it is made here when None or of the other route's layout (a
    misaligned activation takes the dp4a route). A shape whose dp4a tile does
    not fit in shared memory raises ValueError before launch. A failure on
    either route raises; nothing is retried on the other route or on the
    CPU."""
    if torch.compiler.is_exporting():
        return torch.ops.qtt.qconv2d_grouped(q_a, z_eff, a_scale, w_int, w_scale, w_zero, bias,
                                             *conv_args(strides, pads), corr_a,
                                             bool(w_zero_is_zero), out_dtype, groups, w_g)
    dev = q_a.device
    if dev.type == "cpu":
        return qconv2d_grouped_int8_plain(q_a, z_eff, a_scale, w_int, w_scale, w_zero, bias,
                                          strides, pads, corr_a, w_zero_is_zero, out_dtype,
                                          groups)
    if dev.type != "cuda":
        raise ValueError(f"qconv2d_grouped_int8: unsupported device {dev}")
    n, h, w_sp, ci = q_a.shape
    kh, kw, cig, co = w_int.shape
    if groups < 1 or ci != groups * cig or co % groups:
        raise ValueError(f"qconv2d_grouped_int8: {ci} input and {co} output channels do not "
                         f"split into {groups} groups of {cig} inputs")
    (pt, pb), (pl, pr) = pads
    sh, sw = strides
    oh = (h + pt + pb - kh) // sh + 1
    ow = (w_sp + pl + pr - kw) // sw + 1
    cog, taps = co // groups, kh * kw
    aligned = q_a.data_ptr() % 16 == 0 and (w_g is None or w_g.data_ptr() % 16 == 0)
    route = _grouped_route(taps, cig, cog, groups, aligned)
    if route == "wgmma":
        gb = bp = 0
        g_shape, make = (co, taps * _grouped_slice(cig)), blockdiag_weight
    else:
        gb, bp, _, _ = _grouped_tile(taps, cig, cog, groups)
        g_shape, make = (groups, taps, -(-cig // 4), cog, 4), grouped_weight
    _build.require(q_a, "q_a", dev, torch.int8)
    _build.require(corr_a, "corr_a", dev, torch.float32, (1, oh, ow, co))
    for name, t in (("w_scale", w_scale), ("w_zero", w_zero)):
        _build.require(t, name, dev, torch.float32, (co,))
    if bias is not None:
        _build.require(bias, "bias", dev, torch.float32, (co,))
    _build.require(a_scale, "a_scale", dev, torch.float32, ())
    _build.require(z_eff, "z_eff", dev, torch.float32, ())
    out_code = _build.dtype_code(out_dtype)
    if w_g is None or tuple(w_g.shape) != g_shape:
        w_g = make(w_int, groups)
    _build.require(w_g, "w_g", dev, torch.int8, g_shape)
    out = torch.empty((n, oh, ow, co), dtype=out_dtype, device=dev)
    fn = _build.kernel_fn("qconv2d_grouped")
    with _build.device_guard(dev):
        err = fn(_build.ptr(q_a), _build.ptr(w_g), _build.ptr(corr_a), _build.ptr(w_scale),
                 _build.ptr(w_zero), _build.ptr(bias), _build.ptr(a_scale), _build.ptr(z_eff),
                 _build.ptr(out), n, h, w_sp, ci, oh, ow, co, kh, kw, sh, sw, pt, pl, groups,
                 gb, bp, int(bool(w_zero_is_zero)), out_code, int(route == "wgmma"),
                 _build.current_stream(dev))
    _build.check(err, f"qconv2d_grouped ({route})")
    qconv2d_grouped_int8.launches += 1
    qconv2d_grouped_int8.route_launches[route] += 1
    return out


qconv2d_grouped_int8.launches = 0
qconv2d_grouped_int8.route_launches = {"wgmma": 0, "dp4a": 0}


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
    (the epilogue stays f32). ``w_km``: the kernel's own copy of the weight,
    made once by the caller that holds it: ``kmajor_weight(w_int)`` for K3
    (``groups == 1``), ``grouped_kernel_weight(w_int, groups)`` for K3g.
    """
    n, h, w_sp, ci = x.shape
    if ci != groups * w_int.shape[2] or w_int.shape[3] % groups:
        raise ValueError(f"quant_conv2d: {ci} input and {w_int.shape[3]} output channels do not "
                         f"split into {groups} groups of a {tuple(w_int.shape)} kernel")
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
    args = (q_a.contiguous(),
            torch.as_tensor(z_eff, dtype=torch.float32, device=dev).reshape(()),
            torch.as_tensor(a_scale, dtype=torch.float32, device=dev).reshape(()),
            w_int.contiguous(), w_scale.float().reshape(-1), w_zero.float().reshape(-1),
            None if bias is None else bias.float(), tuple(strides), pads,
            corr_a.float().contiguous(), w_zero_is_zero,
            torch.float32 if out_dtype is None else out_dtype)
    if groups != 1:
        return qconv2d_grouped_int8(*args, groups, w_km)
    return qconv2d_int8(*args, w_km)


def quant_conv2d_wo(
    x: torch.Tensor,
    w_int: torch.Tensor,  # (kh, kw, ci, co) int8
    w_scale: torch.Tensor,  # (co,)
    w_zero: torch.Tensor,  # (co,)
    bias: Optional[torch.Tensor] = None,
    strides: Sequence[int] = (1, 1),
    padding: Padding = "SAME",
    groups: int = 1,
    compute_dtype: torch.dtype = torch.float32,
    awq_recip: Optional[torch.Tensor] = None,
    group_size: int = 0,
) -> torch.Tensor:
    """Weight-only-quantized conv (JAX ``qconv.py:127-168``): the weight
    dequantized, ``(w + z)·s`` in float32, then one float32 conv and
    ``+ bias``. JAX computes this in XLA outside any Pallas kernel, so the
    conv is the library's (TF32 off on the card keeps it float32).

    ``compute_dtype`` (bfloat16, float16) rounds the input and the
    dequantized weight to it first, as JAX does; JAX then sums in float32
    (``preferred_element_type``), and so does this conv: each product of
    two such values is exact in float32, and the output is float32. (A
    bfloat16 library conv would round its output to bfloat16.)

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
    if compute_dtype != torch.float32:
        x, w_deq = x.to(compute_dtype), w_deq.to(compute_dtype)
    out = conv_nhwc(x.float(), w_deq.float(), strides, padding, groups)
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
