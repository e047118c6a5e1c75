"""Quantization-aware layers (NHWC activations, HWIO / (in, out) kernels).

PyTorch counterpart of ``quantize_tpu/nn/layers.py``. Models are built
quantized from config; FP32 behaviour is the ``'fp32'`` mode (or
``n_bits >= 32``). Modes: ``fp32``, ``calibrate``, ``quant``, ``pack``,
``packed`` and ``init_adaround`` (the float forward, each AdaRound weight
quantizer writing its ``adaround/V``).

:class:`capture_taps` records layer inputs and outputs with forward hooks,
the reference AdaRound runner's own mechanism, where JAX sows them into its
``taps`` collection (and its ``tap_io`` / ``tap_io_quant`` modes are fp32 /
quant forwards under the hooks here). The packed dispatch mirrors ``layers.py:236-305`` (dense) and
``layers.py:399-539`` (conv):

* conv weights of at most 4 bits with an even input width a group are
  stored as int4 pairs (``w_p4c``) and unpacked at each forward;
* depthwise convs (``groups == in_ch``, no residual) -> the activation
  fake-quantized and the weight dequantized, both cast to the carry dtype,
  then one float32 library conv with f32 sums, ``+ bias`` and the cast (no
  kernel, as in JAX);
* conv, 1x1/stride 1 with a residual and zero weight zero points -> the
  fused tail (kernel K2, :func:`~quantize_tpu_torch.ops.qconv1x1.conv1x1_residual`);
* the stride-2 stem with ``s2d`` -> space-to-depth rewrite, then K3;
* every other conv -> :func:`~quantize_tpu_torch.ops.qconv.quant_conv2d`: K3,
  or K3g for a grouped conv;
* dense with per-tensor activations -> :func:`~quantize_tpu_torch.ops.qmatmul.quant_matmul_w8a8`
  (K1), or :func:`~quantize_tpu_torch.ops.qmatmul.quant_matmul_w4a8` (K4) for
  int4 weights with an even K (stored split-half packed as ``w_p4``); a
  deferred LayerNorm (``pre_norm``) fuses into the activation quantize (K7);
* dense without a fusable activation quantizer -> the weight-only
  :func:`~quantize_tpu_torch.ops.qmatmul.quant_matmul_wo` (K5);
* conv without a fusable activation quantizer (weight-only, or
  per-channel activations fake-quantized first) ->
  :func:`~quantize_tpu_torch.ops.qconv.quant_conv2d_wo` (grouped too), then
  the unfused residual tail;
* AWQ layers (``packed/awq_recip``: the weight stored as Q(w·awq), 1/awq
  folded into the dequantized weight, per group with ``q_group_size``) ->
  the weight-only :func:`~quantize_tpu_torch.ops.qmatmul.quant_matmul_wo` /
  :func:`~quantize_tpu_torch.ops.qconv.quant_conv2d_wo` layouts, which
  reach no kernel, as in JAX.

Bias correction (``bias_correct``) keeps E[x] in ``qobs/bias_correct_EX``
during calibration and adds the layer's response to the weight error
W·static - W_hat to the bias in quant mode and at pack time.

On a model-sharded mesh (:mod:`~quantize_tpu_torch.parallel.tensor_parallel`)
a layer set to run on its slice of the out channels (``tp_shard``) runs
every mode there (forward and backward in the training modes), each
gathering its output whole: ``calibrate`` observes the whole input and the
weight's slice, ``pack`` writes the slice's deploy buffers,
``init_adaround`` writes the slice's ``V`` (elementwise in the slice's
kernel and per-channel qparams: the slice of one device's ``V``, bit for
bit). On a mesh with more than one ``data`` rank, calibration
reduces every observer over ``data`` (``data_group``; the bias corrector's
batch mean too).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from ..ops.qconv import (conv_nhwc, conv_zero_correction_map, grouped_kernel_weight,
                         kmajor_weight, quant_conv2d, quant_conv2d_wo, s2d_block_padding,
                         s2d_kernel, space_to_depth)
from ..ops.layernorm import layernorm, layernorm_quant_int8
from ..ops.qconv1x1 import conv1x1_residual
from ..ops.qmatmul import (kmajor_packed, pack_int4_splithalf, quant_matmul_w4a8,
                           quant_matmul_w8a8, quant_matmul_wo, quantize_act_int8,
                           unpack_int4_splithalf)
from ..quant.fakequant import fake_quant
from ..quant.observers import BiasCorrect
from ..quant.pack import pack_int4_pairs, unpack_int4_pairs
from ..quant.qspec import QuantSpec, _freeze
from .precision import packed_carry_dtype
from .qtensor import QTensor
from .quantizer import Quantizer, awq_group
from .variables import VarModule


@dataclasses.dataclass(frozen=True)
class LayerQuantCfg:
    """Resolved per-layer quantization parameters.

    ``weight``/``activation`` are the reference's ``w_setting``/``a_setting``
    dicts; ``bias_correct`` enables the corrector; ``bn_folding`` marks that
    a following BN is folded into this layer at import time (``into_scale``
    folds into the quantizer's static_scale instead of the weight data,
    reference ``quantconv2d.py:115-133``).
    """

    weight: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    activation: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    bias_correct: Union[Mapping[str, Any], bool, None] = None
    bn_folding: Union[Mapping[str, Any], bool, None] = None

    def __post_init__(self):
        object.__setattr__(self, "weight", _freeze(dict(self.weight or {})))
        object.__setattr__(self, "activation", _freeze(dict(self.activation or {})))
        bc = self.bias_correct
        object.__setattr__(self, "bias_correct", _freeze(dict(bc)) if isinstance(bc, Mapping) else bc)
        bf = self.bn_folding
        object.__setattr__(self, "bn_folding", _freeze(dict(bf)) if isinstance(bf, Mapping) else bf)

    @property
    def into_scale(self) -> bool:
        if self.bn_folding and not isinstance(self.bn_folding, bool):
            return bool(dict(self.bn_folding).get("into_scale", False))
        return False

    def bias_correct_kwargs(self) -> dict:
        if isinstance(self.bias_correct, bool) or self.bias_correct is None:
            return {}
        return dict(self.bias_correct)


FP32 = LayerQuantCfg(weight={"n_bits": 32}, activation={"n_bits": 32})

_MODES = ("fp32", "calibrate", "quant", "pack", "packed", "init_adaround")


def lecun_normal_(t: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """flax's ``lecun_normal`` (truncated normal on [-2, 2] std, variance
    1/fan_in), drawn on the CPU from ``generator`` and copied to ``t``."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    # inverse-CDF sampling of the standard normal truncated to [-2, 2]
    cdf = lambda v: 0.5 * (1.0 + math.erf(v / math.sqrt(2.0)))  # noqa: E731
    u = torch.empty(t.shape, dtype=torch.float32)
    u.uniform_(2 * cdf(-2.0) - 1, 2 * cdf(2.0) - 1, generator=generator)
    z = torch.erfinv(u).mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0)
    with torch.no_grad():
        t.copy_(z * std)


class _QuantLayerBase(VarModule):
    """Shared calibrate / quant / pack plumbing for dense and conv layers."""

    def _setup(self, quant: LayerQuantCfg, kernel_shape: Tuple[int, ...], in_ch: int,
               with_bias: bool, device) -> None:
        self.quant = quant
        self.kernel_shape = tuple(kernel_shape)
        # this rank's slice of the out channels under tensor parallelism
        # (parallel/tensor_parallel.py), set where sharded variables load
        self.tp_shard = None
        # the mesh's ``data`` group (two ranks or more), set where variables
        # load onto a mesh: the bias corrector's batch mean is reduced over it
        self.data_group = None
        self.w_spec = QuantSpec.from_config(dict(quant.weight), "weight", channel_axis=-1)
        self.a_spec = QuantSpec.from_config(dict(quant.activation), "activation", channel_axis=-1)
        self.corrector = BiasCorrect(**quant.bias_correct_kwargs()) if quant.bias_correct else None
        self.put_var("params", "kernel", torch.zeros(kernel_shape, dtype=torch.float32, device=device))
        if with_bias:
            self.put_var("params", "bias", torch.zeros((kernel_shape[-1],), dtype=torch.float32, device=device))
        g = awq_group(self.w_spec)
        # AWQ with q_group_size: one scale per group of g in-features
        n_w = math.prod(kernel_shape) // g if g else self.w_spec.n_channels(kernel_shape)
        self.w_quantizer = Quantizer(self.w_spec, n_w, device)
        self.a_quantizer = Quantizer(self.a_spec, in_ch if self.a_spec.per_channel else 1, device)

    def set_tp_shard(self, shard) -> None:
        """Run on ``shard``'s slice of the out channels, or whole (None);
        the weight quantizer then sums the gradients of its whole leaves
        over the shard's group (:mod:`~quantize_tpu_torch.parallel.tensor_parallel`)."""
        self.tp_shard = shard
        self.w_quantizer.layer_shard = shard

    def param_shape(self, leaf: str) -> Optional[Tuple[int, ...]]:
        """The shape a ``params`` leaf loads at: the float kernel's and the
        bias's, their out channels cut to the slice on a split layer."""
        if leaf not in ("kernel", "bias"):
            return None
        shape = self.kernel_shape if leaf == "kernel" else self.kernel_shape[-1:]
        if self.tp_shard is not None:
            shape = (*shape[:-1], self.tp_shard.hi - self.tp_shard.lo)
        return shape

    def put_var(self, collection: str, leaf: str, value: torch.Tensor) -> torch.Tensor:
        if (collection == "params" and self.has_var(collection, leaf)
                and self.get_var(collection, leaf).shape != value.shape
                and tuple(value.shape) == self.param_shape(leaf)):
            # a slice where the whole was (or back): a new parameter in place
            attr = self._var_index[(collection, leaf)]
            self._parameters[attr] = torch.nn.Parameter(value.detach().clone())
            return self._parameters[attr]
        return super().put_var(collection, leaf, value)

    def init_params(self, generator: torch.Generator) -> None:
        kernel = self.get_var("params", "kernel")
        lecun_normal_(kernel, int(math.prod(kernel.shape[:-1])), generator)
        if self.has_var("params", "bias"):
            with torch.no_grad():
                self.get_var("params", "bias").zero_()

    def _bias(self) -> Optional[torch.Tensor]:
        return self.get_var("params", "bias") if self.has_var("params", "bias") else None

    def _corrected_bias(self, kernel: torch.Tensor, wq: torch.Tensor,
                        bias: Optional[torch.Tensor], whole: bool = False
                        ) -> Optional[torch.Tensor]:
        """``bias`` plus the bias correction (the layer's response on E[x] to
        the weight error W·static - W_hat, reduced to one value per out
        channel) once the corrector has calibrated; else ``bias``. With
        ``whole`` a layer on a slice gathers the weight error and cuts its
        slice of the whole response: the pack then holds one device's bits
        (a float conv or matmul over fewer channels may sum in another
        order)."""
        if self.corrector is None or not self.has_var("qobs", "bias_correct_EX/EX"):
            return bias
        ori = self.w_quantizer(kernel, mode="fp32")
        ex = {"EX": self.get_var("qobs", "bias_correct_EX/EX")}
        delta, shard = ori - wq, self.tp_shard if whole else None
        if shard is not None:
            from ..parallel.tensor_parallel import all_gather

            delta = all_gather(delta, shard.group, dim=-1)
        corr = self._bias_reduce(self.corrector.correction(
            ex, delta, lambda dw, e: self._contract(e, dw)))
        if shard is not None:
            corr = shard.cut(corr)
        return corr if bias is None else bias + corr

    def _run(self, x: torch.Tensor, mode: str) -> torch.Tensor:
        shard = self.tp_shard
        kernel, bias = self.get_var("params", "kernel"), self._bias()
        if mode == "calibrate":
            # on a slice: the activation observer sees the whole input, the
            # weight observer the slice; the output is gathered below
            self.a_quantizer(x, mode="calibrate")
            self.w_quantizer(kernel, mode="calibrate", pre_act=x,
                             apply_fn=lambda w, a: self._contract(a, w))
            if self.corrector is not None:
                ex = (self.get_var("qobs", "bias_correct_EX/EX")
                      if self.has_var("qobs", "bias_correct_EX/EX")
                      else self.corrector.init_state(tuple(x.shape[1:]), device=x.device)["EX"])
                rows = ((self.data_group, 0),) if self.data_group is not None else ()
                self.put_var("qobs", "bias_correct_EX/EX",
                             self.corrector.calibrate({"EX": ex}, x, rows)["EX"])
            xq, wq = self.a_quantizer(x, mode="fp32"), self.w_quantizer(kernel, mode="fp32")
        else:
            xq = self.a_quantizer(x, mode=mode)
            if shard is not None:
                # after the activation fake quant: its input gradient is
                # then the sum over the slices on every rank
                xq = shard.enter(xq)
            wq = self.w_quantizer(kernel, mode=mode)
        if mode == "quant":
            bias = self._corrected_bias(kernel, wq, bias)
        out = self._contract(xq, wq)
        out = out if bias is None else out + bias
        return out if shard is None else shard.gather(out)

    def _pack(self, x: torch.Tensor) -> torch.Tensor:
        """mode='pack': bake the bias correction into the bias, quantize the
        weight to its integer grid and store the deploy buffers in the
        ``packed`` collection (AWQ also ``awq_recip`` = 1/awq_scale);
        returns the FP32 forward so the pack pass flows through the whole
        network. On a slice of the out channels it writes the slice's
        buffers (a per-tensor weight scale expanded to the slice's length)
        and gathers its output."""
        w_spec, a_spec = self.w_spec, self.a_spec
        kernel, bias = self.get_var("params", "kernel"), self._bias()
        n_out = kernel.shape[-1]
        ori = self.w_quantizer(kernel, mode="fp32")
        if self.corrector is not None:
            bias = self._corrected_bias(kernel, self.w_quantizer(kernel, mode="quant"), bias,
                                        whole=True)
        self.put_var("packed", "bias", torch.zeros((n_out,), dtype=torch.float32, device=x.device)
                     if bias is None else bias.detach().float().clone())
        if w_spec.enabled:
            q, w_scale, w_zero = self.w_quantizer(kernel, mode="pack")
            # shift unsigned grids into int8 range, folding into the zero
            shift = (1 << (w_spec.n_bits - 1)) if w_spec.qmin >= 0 else 0
            q_i8 = (q - shift).to(torch.int8)
            w_zero = w_zero.float() + shift
            w_scale = w_scale.float().reshape(-1)
            w_zero = w_zero.reshape(-1)
            if w_scale.numel() in (1, n_out):
                w_scale = w_scale.expand(n_out).contiguous()
                w_zero = w_zero.expand(n_out).contiguous()
            self.put_var("packed", "w_scale", w_scale)
            self.put_var("packed", "w_zero", w_zero)
            awq = self.w_quantizer(kernel, mode="awq_vector")
            if awq is not None:
                # the deploy dequant divides rows by awq: store the reciprocal
                # (a true division by a tensor, also on CUDA)
                awq = awq.float()
                self.put_var("packed", "awq_recip", torch.ones_like(awq) / awq)
            self._store_weight(x, q_i8)
        if a_spec.enabled:
            a_scale, a_zero = self.a_quantizer(x, mode="export_qparams")
            self.put_var("packed", "a_scale", a_scale.float())
            self.put_var("packed", "a_zero", a_zero.float())
        out = self._contract(x, ori)
        out = out if bias is None else out + bias
        return out if self.tp_shard is None else self.tp_shard.gather(out)

    def _awq_packed(self):
        """``(awq_recip, group_size)`` of an AWQ layer's deploy buffers, else
        ``(None, 0)``."""
        if not self.has_var("packed", "awq_recip"):
            return None, 0
        return self.get_var("packed", "awq_recip"), awq_group(self.w_spec)

    def _packed_act(self, x: torch.Tensor) -> torch.Tensor:
        a_scale = self.get_var("packed", "a_scale")
        a_zero = self.get_var("packed", "a_zero")
        return fake_quant(x, a_scale, a_zero, self.a_spec.qmin, self.a_spec.qmax, channel_axis=-1)

    def _fused_act_qparams(self):
        """(a_scale, a_zero) as 0-d tensors when the activation quantize can
        fuse into the int8 kernels (per-tensor), else None."""
        if not self.a_spec.enabled or self.a_spec.per_channel:
            return None
        return (self.get_var("packed", "a_scale").reshape(()),
                self.get_var("packed", "a_zero").reshape(()))


class QuantDense(_QuantLayerBase):
    """Quantized dense layer; kernel (in, out)."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 quant: LayerQuantCfg = FP32, device=None):
        super().__init__()
        self.in_features, self.features = in_features, features
        self._setup(quant, (in_features, features), in_features,
                    bool(use_bias or quant.bias_correct), device)

    def _contract(self, a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return a @ w

    def _bias_reduce(self, c: torch.Tensor) -> torch.Tensor:
        return c

    def _use_p4(self, k: int) -> bool:
        return self.w_spec.enabled and self.w_spec.n_bits <= 4 and k % 2 == 0

    def put_var(self, collection: str, leaf: str, value: torch.Tensor) -> torch.Tensor:
        out = super().put_var(collection, leaf, value)
        if (collection == "packed" and leaf in ("w_p4", "w_int") and self.a_spec.enabled
                and not self.a_spec.per_channel):
            # K4's and K1's wgmma routes read the weight K-major: made here,
            # once per packed weight (at pack or load time), as a buffer
            # outside the packed collection
            name = "w_p4_kmajor" if leaf == "w_p4" else "w_kmajor"
            self.register_buffer(name, kmajor_packed(out), persistent=False)
        return out

    def _store_weight(self, x: torch.Tensor, q_i8: torch.Tensor) -> None:
        if self._use_p4(q_i8.shape[0]):
            self.put_var("packed", "w_p4", pack_int4_splithalf(q_i8))
        else:
            self.put_var("packed", "w_int", q_i8)
        self.put_var("packed", "col_sum", q_i8.sum(dim=0, dtype=torch.int32))

    def _packed_forward(self, x: torch.Tensor, pre_norm=None) -> torch.Tensor:
        if self.tp_shard is not None:
            return self.tp_shard.run(self._packed_local, x, pre_norm=pre_norm)
        return self._packed_local(x, pre_norm)

    def _packed_local(self, x: torch.Tensor, pre_norm=None) -> torch.Tensor:
        w_spec, a_spec = self.w_spec, self.a_spec
        bias = self.get_var("packed", "bias")
        p4 = self._use_p4(x.shape[-1])

        def norm(x):
            # non-fused path: apply the deferred LayerNorm first (kernel K6)
            return x if pre_norm is None else layernorm(x, *pre_norm, out_dtype=x.dtype)

        if not w_spec.enabled:
            x = norm(x)
            xq = self._packed_act(x) if a_spec.enabled else x
            return xq @ self.get_var("params", "kernel") + bias
        w_scale = self.get_var("packed", "w_scale")
        w_zero = self.get_var("packed", "w_zero")
        awq_recip, group = self._awq_packed()
        # symmetric signed weights pack with zero == 0 exactly, so the
        # rowsum(A) correction terms vanish
        wz0 = bool(w_spec.symmetric and w_spec.qmin < 0)
        act = self._fused_act_qparams()
        if act is not None and awq_recip is None:
            a_scale, a_zero = act
            pre_q = None
            if pre_norm is not None:
                # LN fused with the activation quantize (kernel K7): int8
                # out of the kernel, the normalized tensor never stored
                pre_q = layernorm_quant_int8(x, *pre_norm, a_scale, a_zero,
                                             a_spec.qmin, a_spec.qmax)
            col_sum = self.get_var("packed", "col_sum")
            if p4:
                return quant_matmul_w4a8(x, a_scale, a_zero, a_spec.qmin, a_spec.qmax,
                                         self.get_var("packed", "w_p4"), w_scale, w_zero, bias,
                                         col_sum, w_zero_is_zero=wz0, pre_q=pre_q,
                                         w_km=self.w_p4_kmajor)
            return quant_matmul_w8a8(x, a_scale, a_zero, a_spec.qmin, a_spec.qmax,
                                     self.get_var("packed", "w_int"), w_scale, w_zero, bias,
                                     col_sum, w_zero_is_zero=wz0, pre_q=pre_q,
                                     w_km=self.w_kmajor)
        # weight-only (or per-channel activations, or AWQ): float
        # activations times the dequantized weight
        w_int = (unpack_int4_splithalf(self.get_var("packed", "w_p4")) if p4
                 else self.get_var("packed", "w_int"))
        x = norm(x)
        xq = self._packed_act(x) if a_spec.enabled else x
        return quant_matmul_wo(xq, w_int, w_scale, w_zero, bias, awq_recip=awq_recip,
                               group_size=group)

    def packed_proj_buffers(self) -> dict:
        """This layer's deploy buffers, so that a parent module can run
        sibling projections as ONE fused matmul (the q/k/v projections of
        :class:`~quantize_tpu_torch.nn.attention.QuantMultiheadAttention`)."""
        out = {name: self.get_var("packed", name) for name in ("bias", "w_scale", "w_zero")}
        for name in ("w_int", "w_p4", "col_sum", "a_scale", "a_zero"):
            if self.has_var("packed", name):
                out[name] = self.get_var("packed", name)
        for name in ("w_p4_kmajor", "w_kmajor"):
            if hasattr(self, name):
                out[name] = getattr(self, name)
        return out

    def forward(self, x: torch.Tensor, mode: str = "fp32", pre_norm=None) -> torch.Tensor:
        if mode == "packed":
            return self._packed_forward(x, pre_norm).to(packed_carry_dtype())
        if pre_norm is not None:
            raise ValueError("pre_norm fusion is a packed-mode feature")
        if mode == "pack":
            return self._pack(x)
        if mode not in _MODES:
            raise ValueError(f"unknown mode {mode!r}")
        return self._run(x, mode)


class QuantConv(_QuantLayerBase):
    """Quantized 2-D convolution: NHWC input, HWIO kernel."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: Sequence[int] = (3, 3), strides: Sequence[int] = (1, 1),
                 padding: Union[str, Sequence[Tuple[int, int]]] = "SAME",
                 feature_group_count: int = 1, use_bias: bool = True,
                 quant: LayerQuantCfg = FP32, s2d: bool = False, device=None):
        super().__init__()
        self.features = features
        self.kernel_size = tuple(kernel_size)
        self.strides = tuple(strides)
        self.padding = padding if isinstance(padding, str) else [tuple(p) for p in padding]
        self.in_features = in_features
        self.feature_group_count = feature_group_count
        self.s2d = s2d
        kh, kw = self.kernel_size
        needs_bias = bool(use_bias or quant.bias_correct or quant.bn_folding)
        self._setup(quant, (kh, kw, in_features // feature_group_count, features),
                    in_features, needs_bias, device)

    def _contract(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return conv_nhwc(x, w, self.strides, self.padding, self.feature_group_count)

    def _bias_reduce(self, c: torch.Tensor) -> torch.Tensor:
        return c.mean(dim=(0, 1))  # (H', W', C) -> (C,)

    def _wz0(self) -> bool:
        # zero == 0 exactly only for symmetric *signed* grids (unsigned
        # symmetric packs with a +2^(b-1) shift folded into w_zero)
        return bool(self.w_spec.symmetric and self.w_spec.qmin < 0)

    def _s2d_stem(self) -> bool:
        return (self.s2d and self.strides == (2, 2) and self._wz0()
                and not isinstance(self.padding, str))

    def _use_p4c(self) -> bool:
        # int4 pairs along the kernel's input channels (a group's own)
        cig = self.in_features // self.feature_group_count
        return self.w_spec.enabled and self.w_spec.n_bits <= 4 and cig % 2 == 0

    def put_var(self, collection: str, leaf: str, value: torch.Tensor) -> torch.Tensor:
        out = super().put_var(collection, leaf, value)
        if (collection == "packed" and leaf in ("w_int", "w_p4c") and self.a_spec.enabled
                and not self.a_spec.per_channel):
            # the int8 kernels' own copies of the weight, made here once per
            # packed weight (at pack or load time) as buffers outside the
            # packed collection: K3's and K2's K-major copy and, for a 1x1
            # kernel, K2's column sums (for the stem also the space-to-depth
            # weight and its copy), or the copy K3g's route for this shape
            # reads
            w_int = unpack_int4_pairs(out, axis=2) if leaf == "w_p4c" else out
            if self.feature_group_count > 1:
                self.register_buffer("w_grouped",
                                     grouped_kernel_weight(w_int, self.feature_group_count),
                                     persistent=False)
            else:
                self.register_buffer("w_kmajor", kmajor_weight(w_int), persistent=False)
                if self.kernel_size == (1, 1):
                    self.register_buffer("w_colsum", w_int.reshape(w_int.shape[2:]).sum(
                        dim=0, dtype=torch.int32), persistent=False)
                if self._s2d_stem():
                    w_s2d = s2d_kernel(w_int)
                    self.register_buffer("w_s2d", w_s2d, persistent=False)
                    self.register_buffer("w_s2d_kmajor", kmajor_weight(w_s2d), persistent=False)
        return out

    def _store_weight(self, x: torch.Tensor, q_i8: torch.Tensor) -> None:
        if self._use_p4c():
            self.put_var("packed", "w_p4c", pack_int4_pairs(q_i8, axis=2))
        else:
            self.put_var("packed", "w_int", q_i8)
        if self.a_spec.enabled and not self.a_spec.per_channel:
            # pack-time zero-point correction map for this input size
            self.put_var("packed", "corr_a", conv_zero_correction_map(
                q_i8, x.shape[1], x.shape[2], self.strides, self.padding))

    def _packed_forward(self, x: torch.Tensor, residual=None, fuse_relu: bool = False,
                        return_qinput: bool = False):
        if self.tp_shard is not None:
            return self.tp_shard.run(self._packed_local, x, residual=residual,
                                     fuse_relu=fuse_relu, return_qinput=return_qinput)
        return self._packed_local(x, residual, fuse_relu, return_qinput)

    def _packed_local(self, x: torch.Tensor, residual=None, fuse_relu: bool = False,
                      return_qinput: bool = False):
        w_spec, a_spec = self.w_spec, self.a_spec
        bias = self.get_var("packed", "bias")

        def _finish(out):
            # with return_qinput every branch returns (out, qin), as JAX's:
            # qin None where no int8 input is shared (not fusable, AWQ,
            # weight-only). Else the unfused residual tail: cast to the
            # carry dtype, then add + relu
            if return_qinput:
                return out, None
            if residual is None:
                return out
            out = out.to(packed_carry_dtype()) + residual
            return torch.relu(out) if fuse_relu else out

        if not w_spec.enabled:
            xq = self._packed_act(x) if a_spec.enabled else x
            return _finish(self._contract(xq, self.get_var("params", "kernel")) + bias)
        # JAX's branches in JAX's order (layers.py:422-539)
        w_scale = self.get_var("packed", "w_scale")
        w_zero = self.get_var("packed", "w_zero")
        if self.has_var("packed", "w_p4c"):
            w_int = unpack_int4_pairs(self.get_var("packed", "w_p4c"), axis=2)
        else:
            w_int = self.get_var("packed", "w_int")
        groups = self.feature_group_count
        conv_kw = dict(strides=self.strides, padding=self.padding, groups=groups)
        awq_recip, group = self._awq_packed()
        if awq_recip is not None:
            # AWQ deploys weight-only (JAX layers.py:427-443): the stored
            # Q(w·awq) dequantized with 1/awq folded in; activations still
            # fake-quantized where enabled
            xq = self._packed_act(x) if a_spec.enabled else x
            return _finish(quant_conv2d_wo(xq, w_int, w_scale, w_zero, bias, awq_recip=awq_recip,
                                           group_size=group, **conv_kw))
        if groups > 1 and groups == x.shape[-1] and residual is None and not return_qinput:
            # depthwise (JAX layers.py:445-471): the quantized math as float
            # on the library's conv, no int8 kernel (one that carries its
            # int8 input takes K3g below). Both operands are cast to
            # the carry dtype, as JAX casts them, then summed in float32 (the
            # card's TF32 off), + bias, cast: JAX keeps f32 sums through the
            # bias, which a bf16 conv would round first
            cdt = packed_carry_dtype()
            xq = (self._packed_act(x) if a_spec.enabled else x).to(cdt)
            w_deq = ((w_int.float() + w_zero) * w_scale).to(cdt)
            out = conv_nhwc(xq.float(), w_deq.float(), self.strides, self.padding, groups) + bias
            return out.to(cdt)
        act = self._fused_act_qparams()
        if act is None:
            # weight-only (or per-channel activations): float activations
            # through the dequantized weight (JAX layers.py:535-539)
            xq = self._packed_act(x) if a_spec.enabled else x
            return _finish(quant_conv2d_wo(xq, w_int, w_scale, w_zero, bias, **conv_kw))
        a_scale, a_zero = act
        corr_a = self.get_var("packed", "corr_a") if self.has_var("packed", "corr_a") else None
        q_a, z_eff = quantize_act_int8(x, a_scale, a_zero, a_spec.qmin, a_spec.qmax)
        wz0 = self._wz0()
        pad_zero = (self.padding.upper() in ("VALID", "SAME")
                    if isinstance(self.padding, str)  # identical for 1x1/s1
                    else tuple(map(tuple, self.padding)) == ((0, 0), (0, 0)))
        if (residual is not None and wz0 and pad_zero and self.kernel_size == (1, 1)
                and self.strides == (1, 1) and groups == 1):
            return conv1x1_residual(q_a, z_eff, a_scale, w_int, w_scale, bias, residual,
                                    relu=fuse_relu, col_sum_w=self.w_colsum,
                                    out_dtype=packed_carry_dtype(), w_km=self.w_kmajor)
        x_sh = x
        w_km = self.w_grouped if groups > 1 else self.w_kmajor
        if self._s2d_stem() and groups == 1 and not return_qinput:
            kh, kw = w_int.shape[:2]
            bp = s2d_block_padding(kh, kw, list(self.padding), x.shape[1], x.shape[2])
            if bp is not None and corr_a is not None:
                # exact rewrite: stride-1 conv over 2x2 depth-stacked input;
                # the pack-time corr_a carries over (same output grid)
                q_a = space_to_depth(q_a)
                w_int, w_km = self.w_s2d, self.w_s2d_kmajor
                x_sh, conv_kw = q_a, dict(strides=(1, 1), padding=bp, groups=1)
        out = quant_conv2d(x_sh, a_scale, a_zero, a_spec.qmin, a_spec.qmax, w_int, w_scale,
                           w_zero, bias, w_zero_is_zero=wz0, corr_a=corr_a,
                           pre_q=(q_a, z_eff), out_dtype=packed_carry_dtype(), w_km=w_km,
                           **conv_kw)
        if return_qinput:
            return out, QTensor(q_a, a_scale.float(), z_eff)
        return _finish(out)

    def forward(self, x: torch.Tensor, mode: str = "fp32", residual=None,
                fuse_relu: bool = False, return_qinput: bool = False):
        """``return_qinput`` (packed mode only): return ``(out, qin)``, qin
        the :class:`~.qtensor.QTensor` of the int8 input where the int8 path
        ran, else None (JAX ``QuantConv.return_qinput``)."""
        if return_qinput and mode != "packed":
            raise ValueError("QuantConv: return_qinput is a packed-mode feature")
        if mode == "packed":
            if residual is not None and return_qinput:
                raise ValueError("QuantConv: residual fusion and return_qinput are mutually "
                                 "exclusive (the qin-carry path has no fused residual tail)")
            out = self._packed_forward(x, residual, fuse_relu, return_qinput)
            if return_qinput:
                return out[0].to(packed_carry_dtype()), out[1]
            return out.to(packed_carry_dtype())
        if mode == "pack":
            return self._pack(x)
        if mode not in _MODES:
            raise ValueError(f"unknown mode {mode!r}")
        out = self._run(x, mode)
        if residual is not None:
            out = out + residual
            if fuse_relu:
                out = torch.relu(out)
        return out


class _ActQuantLayer(VarModule):
    """Activation-only quantization in front of an op."""

    def __init__(self, quant: LayerQuantCfg = FP32, in_ch: int = 1, device=None):
        super().__init__()
        self.a_spec = QuantSpec.from_config(dict(quant.activation), "activation", channel_axis=-1)
        self.a_quantizer = Quantizer(self.a_spec, in_ch if self.a_spec.per_channel else 1, device)

    def _quantize_in(self, x: torch.Tensor, mode: str) -> torch.Tensor:
        q = self.a_quantizer
        if mode == "calibrate":
            q(x, mode="calibrate")
            return q(x, mode="fp32")
        if mode == "pack":
            return q(x, mode="fp32")
        if mode == "packed":
            # activation-only layers need no packed buffers: fake-quant with
            # the stored qparams is already the deploy behaviour
            return q(x, mode="quant")
        return q(x, mode=mode)


class QuantReLU(_ActQuantLayer):
    def forward(self, x: torch.Tensor, mode: str = "fp32") -> torch.Tensor:
        return torch.relu(self._quantize_in(x, mode))


def max_pool_nhwc(x: torch.Tensor, window: Sequence[int], strides: Sequence[int],
                  padding: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """Max pool over NHWC with explicit -inf padding (flax semantics)."""
    (pt, pb), (pl, pr) = padding
    xc = F.pad(x.permute(0, 3, 1, 2), (pl, pr, pt, pb), value=float("-inf"))
    return F.max_pool2d(xc, tuple(window), tuple(strides)).permute(0, 2, 3, 1)


class QuantMaxPool(_ActQuantLayer):
    def __init__(self, window=(2, 2), strides=(2, 2), padding=((0, 0), (0, 0)),
                 quant: LayerQuantCfg = FP32, in_ch: int = 1, device=None):
        super().__init__(quant, in_ch, device)
        self.window, self.strides, self.padding = tuple(window), tuple(strides), padding

    def forward(self, x: torch.Tensor, mode: str = "fp32") -> torch.Tensor:
        return max_pool_nhwc(self._quantize_in(x, mode), self.window, self.strides, self.padding)


class QuantGlobalAvgPool(_ActQuantLayer):
    """Adaptive average pool to 1x1."""

    def forward(self, x: torch.Tensor, mode: str = "fp32") -> torch.Tensor:
        return self._quantize_in(x, mode).mean(dim=(1, 2))


# the layers whose outputs JAX sows into its ``taps`` collection
TAP_LAYERS = (QuantDense, QuantConv, QuantReLU, QuantMaxPool, QuantGlobalAvgPool)


class capture_taps:
    """Record each call's input (``inputs=True``) and output of the model's
    tap layers, by flax path: ``taps[path] = {"in": [...], "out": [...]}``,
    one entry a call, the paths in the order of their first call. ``store``
    maps each recorded tensor (the host copy of a blockwise capture);
    ``paths`` picks the modules."""

    def __init__(self, model: torch.nn.Module, inputs: bool = False,
                 store: Optional[Callable[[torch.Tensor], Any]] = None, paths=None):
        self.model, self.inputs = model, inputs
        self.store = store or (lambda t: t)
        self.paths = None if paths is None else set(paths)
        self.taps: Dict[str, Dict[str, list]] = {}

    def _hook(self, path, mod, args, kwargs, out):
        rec = self.taps.setdefault(path, {"in": [], "out": []})
        if self.inputs:
            rec["in"].append(self.store(args[0] if args else kwargs["x"]))
        rec["out"].append(self.store(out))

    def __enter__(self):
        self.handles = []
        for name, mod in self.model.named_modules():
            path = name.replace(".", "/")
            if isinstance(mod, TAP_LAYERS) and (self.paths is None or path in self.paths):
                self.handles.append(mod.register_forward_hook(
                    lambda m, a, k, o, path=path: self._hook(path, m, a, k, o),
                    with_kwargs=True))
        return self

    def __exit__(self, *exc):
        for h in self.handles:
            h.remove()
