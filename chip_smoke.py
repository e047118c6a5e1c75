#!/usr/bin/env python3
"""Run the quantize_tpu_torch port on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card and nvcc

Phases (any failure exits non-zero; the last line is printed only on success):

1. Set-up: the card's name and power limit, TF32 off for float32 convs and
   matmuls, and the build of every kernel from ``quantize_tpu_torch/csrc``
   (one nvcc per source, all started together).
2. ResNet-50 W8A8 (symmetric per-channel weights, asymmetric per-tensor
   activations, folded BN), 1000 classes, 224x224, random weights from
   seed 0: init, MinMax calibration on 4 batches of 32, pack, then 4
   requests of batch 256 served in ``mode="packed"`` with the fused residual
   tail on. The launch counters are zeroed just before the requests and read
   just after: K3 37, K2 16, K1 1 and KQ (the activation quantize) 54 per
   forward, every K2 and K1 launch on its wgmma route (the launches by
   route are printed; also in the bf16-carry request), and K1's device time
   at the head (torch.profiler) beside its event time. The outputs must be finite,
   within 2e-2 of the quant simulation, within 1e-3 of the unfused path and
   within 5e-2 with a bf16 carry (relative to max|logits|). Then K2 alone on
   random operands at the shapes no model here gives it (``CONV1X1_SHAPES``:
   M = 147, N = 1000, K = 48, the wide tails' K = 1024 and 2048, mixed
   residual/output dtypes, no ReLU or bias, and K = 40 and a bf16 N = 28 on
   the mma.sync route), each on the route its shape selects, bit for bit.
   Then K1 alone on random operands (``W8A8_SHAPES``: ViT-B/16's four W8A8
   projections at batch 128, M = 25,600; the ResNet-50 head; M = 1; a
   cluster of 8 CTAs; K = 40 on the mma.sync route), each on the route its
   shape selects, bit for bit, with its time beside its bound and the
   library call's.
2a. ResNeXt-50 32x4d W8A8 (ResNet-50's model and quant sections: MinMax,
   per-channel symmetric signed weights, per-tensor unsigned activations, BN
   folded), 1000 classes, 224 x 224, from a torchvision-layout state dict
   written from seed 50 (grouped conv2 weights (Co, Ci/G, 3, 3)): imported
   (fp32 logits within 1e-4 of max|logits| of the state dict's NCHW forward,
   BN unfolded), calibrated on 4 batches of 32, packed, then 4 requests of
   256 with the fused residual tail, counted as in phase 2: K3g (the grouped
   int8 conv) 16, K3 21, K2 16, K1 1 and KQ 54 per forward, also at bf16
   carry, every K3g launch on its wgmma route (tensor cores over
   block-diagonal slices; the launches by route are printed, at both
   carries); packed within 2e-2 of the quant simulation, bf16 carry within
   5e-2; every K3g call of one recorded forward at each carry (16 each)
   bit-equal to its plain version, the other kernels at each signature; the
   forward timed beside the float32 forward (TF32 off), K3g's time a forward
   beside its bound, plain version and the bf16 cuDNN grouped conv on the
   dequantized tensors (the nearest library call), K3 and K2 at ResNeXt's
   widths, and where the device time goes (``scripts/profile_torch_port.py``'s
   trace).
2b. K3g alone on random operands (``GROUPED_SHAPES``: the golden case's
   groups 2 with Ci/G 4, ResNeXt-101 32x8d's and 64x4d's widths, group
   widths 1, 2 and 3, asymmetric weights on both routes, stride 2 with JAX's
   asymmetric SAME padding, bf16 output, a group wider than 64 channels,
   5 x 5 kernels on both routes, a 1 x 1 grouped kernel, C not a multiple
   of 64), each on
   the route its shape selects (both routes run), bit for bit, with its time
   beside its bound and the library call's; then ``GROUPED_REFUSED`` (3 x 3
   taps over 1,024 input channels a group, 32 output channels: the dp4a
   route's smallest tile exceeds shared memory, and the wgmma route takes
   only Ci/G == Co/G) raises ValueError by name before launch.
2c. MobileNetV2 W8A8 (``mobile_stack_w8a8``'s quant section), 1000 classes,
   224 x 224, random weights from seed 0, calibrated on 4 batches of 32 and
   packed, then 4 requests of 256: K3 35 (the stem, 16 expand, 17 project
   and the head 1 x 1 convs), K1 1 and KQ 36 per forward, also at bf16
   carry, the 17 depthwise convs on the float path (the library's float32
   conv, no kernel, as in JAX); packed within 2e-2 of the simulation, bf16
   carry within 5e-2; every kernel at each signature bit for bit; timed as
   above, with where its device time goes.
2d. WideResNet-28-10 W8A8 (ResNet-50's quant section; the pre-activation
   fold topology: bn2 folded into conv1, bn1 a live BatchNorm), 10 classes,
   32 x 32, random weights from seed 0, then 4 requests of 256: K3 28 (the
   stem, 24 block convs, 3 shortcuts), K1 1 and KQ 29 per forward; packed
   within 2e-2 of the simulation; every kernel at each signature bit for
   bit; timed beside the float32 forward.
3. The PTQ runner through the CLI (``quantize_tpu_torch.cli.main``, in-process,
   on the card, into a temporary directory): ``RUNNER_CFG``, the CPU config
   as users run it (TestCNN, 32 x 32 synthetic images: 160 calibration
   images at batch 64, the last batch padded, 256 val and 256 test at batch
   128), then at 224 x 224 (the synthetic set for ImageNet): the same config
   at ResNet-50's full width (``model.name=resnet50``: the model and quant
   sections of ``ptq_rn50_w8a8_in1k_16shots.yaml``) from random weights and
   from a torchvision-layout ResNet-50 checkpoint (``model.torch_checkpoint``
   and its ``torch_checkpoint_sha256``; a ``state_dict`` the script writes
   with ``torch.save`` from a seeded generator, BatchNorm statistics and
   ``num_batches_tracked`` included, BN folded at import); then ResNet-18
   from such a checkpoint with the model and quant sections of the
   cross-entropy config (``CE_CFG``: MSE weights and activations, CE on the
   head's activations, W8A8 packed) and of the bias-correction AWQ config
   (``AWQ_CFG``: MSE W8 weight-only, BiasCorrect on every layer, AWQ with
   ``q_group_size`` 128 on the head; its packed path launches no kernel, as
   in JAX); then MobileNetV2 from such a checkpoint with the model and quant
   sections of ``ptq_mbv2_w8only_in1k.yaml`` (8-bit MinMax weights, 32-bit
   activations: weight-only; its convs on the library's float32 conv, as in
   JAX, its classifier on K5); then CLIP ViT-B/16 zero-shot from an
   OpenAI-CLIP-layout checkpoint the script writes (``clip_state_dict``,
   seed 5) with the model (the five prompt templates) and quant sections of
   ``clip_vitb16_zeroshot_in1k.yaml``: the runner computes the zero-shot
   weights over the 10 class names after the import, its packed forward is
   counted as in phase 5a and gated at 5e-2 (the ViT gate), and no NCHW
   forward is compared (none is independent of the port). Each reaches a
   test top-1 in [0, 100] and writes its
   checkpoints, config and log; an imported model's fp32 logits on a test
   batch are within 1e-4 of max|logits| of an independent NCHW forward of
   the state dict with its BatchNorms unfolded, and a wrong
   ``torch_checkpoint_sha256`` raises; a fresh runner loaded from
   ``ckpt_best.pkl`` gives bit-equal quant-mode test logits; that model is
   packed on one padded train batch and serves the test split, counted as
   above (TestCNN: K3 2, K1 2, KQ 4 per forward; ResNet-50: K3 37, K2 16,
   K1 1, KQ 54, K2 and K1 on their wgmma routes; ResNet-18 W8A8: K3 20, K1
   1, KQ 21; the AWQ run: none; MobileNetV2 W8: K5 1), its logits within 2e-2 of the quant-mode
   logits, and every kernel call of one packed test batch bit-equal to its
   plain version (the 10-class head, N = 10, TestCNN's and ResNet-18's
   shapes are new). Printed with the card's name and power limit: the wall
   time from config to test result, the import time, the new shapes'
   per-launch kernel times beside their bounds, and at 224 the CUDA-event
   medians of a calibration step (64), a quant-mode eval batch (128) and a
   packed eval batch (128).
4. ViT-B/16 W4A8 (``bench.py``'s headline with 4-bit weights: int4
   symmetric per-channel MinMax weights, the out-projections' ranges MSE,
   int8 asymmetric per-tensor MinMax activations), 1000 classes, 224x224
   (S = 197 padded to 200), random weights from seed 0: init, calibration
   on 4 batches of 32, pack, then 4 requests of batch 128 in
   ``mode="packed"`` at f32 carry, counted as above: K4 37, K7 24, K8 12,
   K5 12 (the weight-only out-projections), K6 1, K3 1, KQ 14 per forward,
   every K4 launch on its wgmma route and every K7 launch on its vector
   route (the launches by route are printed; K7 also in a bf16-carry
   request).
   The logits must be finite, within 5e-2 of the quant simulation and
   within 5e-2 with a bf16 carry. Then K4 alone on random operands at the
   shapes no model here gives it (``W4A8_SHAPES``: M of 128, 200 and 333,
   N = 1000, K/2 not a multiple of 64 with z_w != 0, and K = 200 on the
   mma.sync route), each on the route its shape selects, bit for bit.
5. ViT-B/32 weight-only W4 (``configs/runners/ptq/weight_quantize/
   mse_channel.yaml`` at 4 bits: symmetric per-channel weights with the MSE
   range search, activations at 32 bits), 1000 classes, 224x224 (S = 50
   padded to 56), random weights from seed 0: init, calibration on 4
   batches of 32, pack, then 4 requests of batch 256 counted as above: K5
   73, K6 25, K8 12 per forward. The logits must be finite, within 5e-2 of
   the quant simulation and within 5e-2 with a bf16 carry. One request is
   served again with ``QTPU_ATTN_INT8=1``: K9 12 and K8 0 per forward, the
   logits within 5e-2 of the default path.
5a. CLIP ViT-B/16 W8A8 (``CFG``), 1000 classes, full width (vision 768 wide,
   12 layers, 12 heads, patch 16 at 224, S = 197 padded to 200; text 512
   wide, 12 layers, 8 heads, context 77 padded to 80, vocabulary 49,408;
   embedding 512), random weights from seed 0: init, calibration of the
   image tower on 4 batches of 32, the zero-shot weights over 1000 class
   names x the five templates of ``configs/datasets/imagenet/prompts.yaml``
   (5,000 prompts, ``HashTokenizer``) through the fp32 text tower, pack,
   then 4 requests of 128 at f32 carry counted as above: K3 1 (the patch
   conv), K1 36, K5 12, K7 24 (vector route), K8 12, KQ 13 a forward (also at
   bf16 carry); packed within 5e-2 of the simulation, bf16 within 5e-2 of
   f32; every kernel at each signature of one forward at each carry
   against its plain version. Then the text tower: ``precompute`` in
   calibrate, quant, pack and packed mode over the 5,000 prompts; one
   packed pass counted: K8 12 (causal, S 80, valid 77: the first causal K8
   launches on a model path), K7 24, K1 36, K5 12, KQ 12; its zero-shot
   weights within 5e-2 (max abs, unit vectors) of quant mode's; every K8
   call of one recorded packed pass held against its plain version as it
   is made (rtol 1e-4 / atol 1e-5), K1, K7 and KQ bit for bit, K5 within
   its limit; the pass timed beside the fp32 pass, each kernel at the text
   widths beside its bound, plain version and library call (causal K8:
   SDPA with the causal and key masks).
5b. CLIP RN50 W8A8's image tower (stages 3-4-6-3 at width 64, the attention
   pool 2,048 wide with 32 heads), 1000 classes, 224, seed 0: calibrated on
   4 x 32, zero-shot weights as in 5a, packed, 4 requests of 128: K3 55,
   K1 4, KQ 59 a forward; packed within 2e-2 of the simulation (the CNN
   gate); every kernel call of one recorded forward bit-equal; the
   attention pool's mean token (49 positions) on the card against the same
   sum / float32 count on the CPU, beside ``Tensor.mean``'s, relative to
   max|token|; timed as above, each kernel at its shapes.
6. Long sequences and wide heads: ViT-B/16 W4A8 as in phase 4 at
   ``image_size=384`` (S = 577 padded to 584, the usual fine-tuning
   resolution), calibrated on 4 batches of 8, then one request of 32 images
   at bf16 carry, counted as above (K8 12 a forward, K4 on its wgmma route,
   K7 on its vector route); the logits finite and within 5e-2 of the f32
   carry; the forward timed without the call recorders. K4 on that
   request's arguments at both carries, bit for bit; K8 and K9 on its
   attention arguments, and on random rows (4 images) at the other shapes the JAX
   dispatch sends them that once exceeded their shared memory
   (``LONG_SHAPES``: K8 at S 488, 680 bf16 and 456 f32, K9 at S 776 bf16,
   E 768, 12 heads; both at head dim 128, S 856 bf16, E 512, 4 heads; both
   at head dims 320 and 512 and at the widest heads the dispatch takes, S = 8
   at head dim 65,528 in bf16 and 49,144 in float32), against their plain
   versions: K8 within its tolerance, K9 bit for bit; the count of K9's
   absmax pre-pass launches (its streamed layout) is printed.
7. Kernels: every kernel is called on the very arguments the main paths
   give it (recorded at each main-path shape, f32 and bf16 carry; ResNet-50's
   four kernels on one request of 256 at each carry; K3 also at ViT's patch
   embedding; K5 at both ViTs'; K9 at
   ViT-B/32's and at ViT-B/16's attention arguments; KQ at every ResNet-50
   and ViT-B/16 call) and held against its plain PyTorch version: K3, K4
   and KQ bit for bit (KQ: 0 int8 values differ, z_eff equal; the count is
   printed); K2 and K1 bit for bit;
   K5 within
   2^-18 * sum|a*w| + 2^-23 * |out| per output, a limit that does not grow
   with K (the reading is printed beside the control: the same product with
   an f32 activation left unrounded, which must exceed the limit); K6
   rtol 1e-5 / atol 1e-5 in f32, one ulp in bf16; K7 bit for bit (0 int8
   values differ, z_eff equal; the count is printed); K8
   rtol 1e-4 / atol 1e-5 in f32, two ulps in bf16; K9 equal but for ex8
   flips (one exp rounding moves one ex8 by a step and one row of one head
   by at most 2.05 * sv) on at most 1e-3 of the (row, head) groups (the
   count is printed).
7a. QAT: ViT-B/16 W4A8 with the model, quant, runner, optimizer and
   schedule sections of ``QAT_CFG`` (W4 per-channel symmetric MinMax
   weights, A8 per-tensor asymmetric ``maminmax`` activations with momentum
   0.1; Adam, lr 1e-5, constant), 1000 classes, 224 x 224 seeded synthetic
   images, float32 with TF32 off: 2 calibration batches of 64 through
   ``QAT.train_step``, the ``calibrated_epoch`` switch, then 3 QAT steps of
   64. One step on 2 images from the same variables on the card and, on a
   copy of the model, on the CPU: the loss within 1e-4 relative, every
   ``params`` and ``qparams`` leaf a finite gradient, the same leaves with a
   nonzero gradient (above 1e-6 of their collection's largest entry), each
   collection's gradient within 1e-2 of its L2 norm. The losses finite; the
   median step time (CUDA events, the first step left out) and the peak
   memory allocated printed, and where a step's device time goes
   (``scripts/profile_torch_port.py``'s trace of 2 steps). The trained
   model packed and served: 4
   requests of 128, launches as phase 4's per forward, packed within 5e-2
   of its quant mode.
7b. AdaRound: MobileNetV2 W4 weight-only with ``ADAROUND_CFG``'s sections
   (W4 per-channel symmetric MinMax weights with ``adaround.apply``, 32-bit
   activations, BN folded; Adam lr 1e-3, beta dynamic), blockwise, 2 cached
   batches of 32 at 224, ``max_epoch`` 2: all 53 layers reconstructed (52
   convs and the classifier), h(V) at init within 1e-5 of the fractional
   part of w / s - z, every final loss finite and every V moved; the packed
   ints of every layer equal to round(floor(w / s - z) + h(V)) bit for
   bit; 4 requests of 128 served packed (the convs on the library's float
   conv, the classifier on K5: 1 a forward) within 2e-2 of the trained quant
   mode, K5's call within its limit of its plain version; the time per
   layer-step and in all printed.
7c. TestCNN through the CLI on ``RUNNER_CFG`` with the QAT and AdaRound
   base configs layered on it (``TRAIN_CLI_RUNS``: QAT, AdaRound joint and
   sequential): a test top-1 in [0, 100] over 256, a checkpoint (holding
   ``adaround`` for AdaRound), the time from config to test result printed.
8a. The int8 carry between blocks (``qin_carry``): ResNet-50 W8A8 as phase
   2, 3 requests of ``CARRY_BATCH`` (256) at 224, served packed under the
   carry at f32 and bf16 carry with the fused tail on (K3 37, K2 16, K1 1,
   KQ 54 a forward; K2's residual is the float32 ``qin.dequant()``) and off
   (K3 53, K1 1, KQ 54): within 8e-2 of max|logits| of the packed forward
   without the carry (JAX ``tests/test_precision.py``'s bound), the argmax
   agreement printed, every kernel call of one forward bit-equal to its
   plain version, each forward timed beside the one without the carry (K2
   at bf16 carry under the carry also per launch beside its bound and
   library call) and where the device time goes under the carry (f32,
   fused); quant mode bit-equal with the flag on and off.
8b. MobileNetV3-Large W8A8 (``CFG_MOBILE``), 256 at 224, under the carry
   at f32 and bf16 carry: the first block's depthwise conv carries its int8
   input, so it is one K3g launch a forward at Ci/G = 1 (16 groups, 112 x
   112) on the ``dp4a`` route, held against its plain version with every
   other call; the other gates as 8a; the forward timed with and without
   the carry and beside the float32 forward, K3g's launch beside its bound
   and the bf16 cuDNN depthwise conv, and where the device time goes with
   and without the carry.
8c. The fault-tolerant run: phase 7a's ViT-B/16 W4A8 QAT configuration
   (``calibrated_epoch`` 1, 3 epochs of 2 steps of 64 on seeded synthetic
   images) through ``runners.resume.supervised_run``, once with a crash
   injected at step 3 (mid-epoch 1) and once with a NaN loss injected at
   step 2 (``FAULT_RUNS``): one restart each with the injected error, the
   resume state ``finished`` at the last epoch, the losses finite, the
   epoch checkpoint reloaded into a fresh runner bit-equal (its size and
   the write and read times printed), the model then packed and served
   (phase 4's launches a forward) within 5e-2 of its quant mode.
8d. ``unpack_model`` of 8a's deploy variables on the card, loaded into a
   fresh ResNet-50: its quant mode within 2e-3 (rtol and atol) of the
   original's; and JAX ``tests/test_packed.py``'s round trip at its own
   config (W8 weight-only ResNet-50): the unpacked model's fp32 forward
   within 2e-3 of the original quant mode. ``profiling.roofline_report``
   of the packed ResNet-50 forward (54 contractions, each kernel wrapper's
   report) with its speed of light beside 8a's measured time, and one
   ``profiling.trace`` of a packed forward, its trace file written.
9a. The serving engine (``parallel/serving.InferenceEngine``): phase 8a's
   ResNet-50 W8A8 at batch 256, fused tail, bf16 carry, then one pass at
   f32 carry: ``SERVE_IMAGES`` (4,096) seeded uint8 images of 224 x 224
   sent by four producer threads (256 by ``submit``, 1,280 by
   ``submit_many``, twice 1,280 by ``submit_batch`` in chunks of 256),
   normalized on the card (ImageNet's mean and std). Counts zeroed just
   before, read just after: K3 37, K2 16, K1 1 and KQ 54 a batch, padded
   batches included, K2 and K1 on their ``wgmma`` routes; no request fails;
   every result bit-equal to that image's row of the direct
   ``model(preprocess(x), mode="packed")`` over batches of 256. One request
   of shape (8, 8, 3), queued beside a good one, fails that batch only, and
   the next 256 are served right. Printed: the engine's img/s by
   ``submit_batch`` at ``max_in_flight`` 4 and 16 (median of 3 runs after
   one left out), the direct forward's img/s back to back (CUDA events,
   the same normalize), the efficiency (engine / direct), mean batch fill,
   the most batches seen in flight, the host staging and dispatch ms a
   batch, the batch's pinned host-to-device copy alone, and the host time
   to queue one forward with the card idle, after checking in torch's sync
   debug mode that a packed forward never waits for the card (a gate).
9b. Device feed: a frame pool of 512 uint8 frames on the card, int32 index
   requests by ``submit_batch``, the argmax as postprocess: the labels equal
   the argmax of the direct forward; launches as 9a; 2 or more batches in
   flight at ``max_in_flight`` 4 and 16 (JAX's count: the batches waiting
   for the drain at a dispatch, the one put included; the dispatch thread
   runs ahead of the card); img/s and efficiency as 9a.
9c. A fresh ResNet-50 given 9a's deploy variables placed by
   ``make_mesh(1, 1)`` and ``shard_variables``, served through the engine
   with ``mesh=``: 1,024 results bit-equal to 9a's. ``make_mesh(2, 1)``
   raises on one card.
9d. Real data: the script writes a CIFAR-10 python-format archive
   (``data_batch_1..5`` and ``test_batch`` of 1,000 seeded images each);
   ``configs/runners/ptq/minmax/ptq_rn18_w8a8_cifar10.yaml`` runs through
   the CLI over it on the card, every batch through ``PrefetchIterator``
   (counted): test top-1 in [0, 100] over 1,000; the first test batch on
   the card equals a numpy decode of the archive with the config's
   ``to_tensor`` and ``normalize``; the best checkpoint, packed, evaluated
   over the test split: K3 20, K1 1, KQ 21 a batch (counted on the CPU
   first). ``quantize_tpu_torch.data`` registers the nine dataset names
   with or without Pillow.
9e. ViT-B/16 W4A8 through the engine at batch 128, f32 carry, two
   ``submit_batch`` chunks: results bit-equal to the direct forward; K4
   37, K7 24, K8 12, K5 12, K6 1, K3 1 and KQ 14 a batch, K4 and K7 on
   their served routes.
9f. Dense packing: the native ``engine.tpack``/``tunpack`` (``g++``-built)
   round-trips phase 8a's 54 ``w_int`` leaves at 8 bits and at 4 bits
   (clamped) bit for bit, its bytes equal to the plain torch version's;
   MB/s of both (host work).
10. Times (CUDA-event medians): each model's packed forward at f32 and bf16
   carry (ViT-B/32 also with int8 scores) beside its float32 forward (TF32
   off) as the yardstick, and each kernel at each of its main-path shapes
   beside its bound, its plain version and the nearest library call (K2
   also at bf16 carry; K4 also beside ``torch._int_mm`` alone; K6 and K8
   also summed over a ViT-B/32 forward).

Before the last line it prints one JSON object with a ``kernels`` list (K1's
and K7's entries also carry ``device_ms``, their torch.profiler device time a
forward: their event times include the wrappers' host work) and the card's
name and power limit; the last line is the ``{"ok": true, ...}`` contract
line.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

# NVIDIA H100 SXM data sheet: dense tensor-core rates, CUDA-core f32, HBM3
PEAK_INT8_OPS = 1979e12
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
# K5 against its plain version, per output and at every K: |diff| <=
# 2^-18 * sum|a*w| + 2^-23 * |out| (the second term is the rounding of
# acc + bias). Summing the same float32 products in another order stays
# below it; skipping the bf16 rounding of an f32 activation does not (phase 6)
WO_LIMIT = 2.0 ** -18

_ACT = {"n_bits": 8, "symmetric": False, "granularity": "layer", "range": {"name": "minmax"}}


def _weight(bits):
    return {"n_bits": bits, "symmetric": True, "signed": True, "granularity": "channel",
            "range": {"name": "minmax"}}


CFG = {"default": {"weight": _weight(8), "activation": _ACT, "bn_folding": True}}
CFG_W4A8 = {"default": {"weight": _weight(4), "activation": _ACT, "bn_folding": True}}
# configs/runners/ptq/weight_quantize/mse_channel.yaml's quant section at 4 bits
CFG_WO = {"default": {"weight": {"n_bits": 4, "symmetric": True, "signed": True,
                                 "granularity": "channel",
                                 "range": {"name": "mse", "maxshrink": 0.8, "grid": 100}},
                      "activation": {"n_bits": 32}, "bn_folding": True}}

KERNEL_INFO = {
    "w8a8_gemm": ("quantize_tpu_torch/csrc/w8a8_gemm.cu",
                  "quantize_tpu/ops/pallas/qmatmul.py:86 (_w8a8_kernel)"),
    "conv1x1_residual": ("quantize_tpu_torch/csrc/conv1x1_residual.cu",
                         "quantize_tpu/ops/pallas/qconv1x1.py:36 (_conv1x1_res_kernel)"),
    "qconv2d": ("quantize_tpu_torch/csrc/qconv2d.cu",
                "quantize_tpu/ops/qconv.py:58 (quant_conv2d, XLA int8 conv)"),
    "qconv2d_grouped": ("quantize_tpu_torch/csrc/qconv2d_grouped.cu",
                        "quantize_tpu/ops/qconv.py:58 (quant_conv2d with groups > 1, XLA int8 "
                        "conv with feature_group_count; row sums :107-119)"),
    "w4a8_gemm": ("quantize_tpu_torch/csrc/w4a8_gemm.cu",
                  "quantize_tpu/ops/pallas/qmatmul.py:228 (_w4a8_kernel)"),
    "layernorm": ("quantize_tpu_torch/csrc/layernorm.cu",
                  "quantize_tpu/ops/pallas/layernorm.py:49 (_ln_kernel)"),
    "layernorm_quant_int8": ("quantize_tpu_torch/csrc/layernorm.cu",
                             "quantize_tpu/ops/pallas/layernorm.py:56 (_ln_q_kernel)"),
    "mha_rows": ("quantize_tpu_torch/csrc/mha_rows.cu",
                 "quantize_tpu/ops/pallas/attention.py:51 (_mha_rows_kernel)"),
    "wo_gemm": ("quantize_tpu_torch/csrc/wo_gemm.cu",
                "quantize_tpu/ops/pallas/qmatmul.py:376 (_wo_kernel)"),
    "mha_rows_int8": ("quantize_tpu_torch/csrc/mha_rows_int8.cu",
                      "quantize_tpu/ops/pallas/attention.py:141 (_mha_rows_int8_kernel)"),
    "quantize_act_int8": ("quantize_tpu_torch/csrc/quantize_act.cu",
                          "quantize_tpu/ops/pallas/qmatmul.py:66 (quantize_act_int8; an XLA "
                          "fusion, not a pallas_call)"),
}
RESNET_PER_FWD = {"qconv2d": 37, "conv1x1_residual": 16, "w8a8_gemm": 1, "quantize_act_int8": 54}
# TestCNN: conv1 and conv2 (K3, Ci 3 and 16), fc1 and fc2 (K1, N 32 and 10),
# each after its activation quantize (KQ); BN folded, no residual
TESTCNN_PER_FWD = {"qconv2d": 2, "w8a8_gemm": 2, "quantize_act_int8": 4}
# ResNet-18 W8A8, BN folded: the stem (space-to-depth) and the 16 3 x 3
# convs and 3 stride-2 1 x 1 downsample convs on K3, the head on K1, each
# after its activation quantize (KQ); no 1 x 1 conv with a residual (no K2)
RESNET18_PER_FWD = {"qconv2d": 20, "w8a8_gemm": 1, "quantize_act_int8": 21}
# ResNeXt-50 32x4d W8A8, BN folded, fused residual tail: each bottleneck's
# grouped 3 x 3 conv2 on K3g; the stem (space-to-depth), conv1 and the 4
# downsamples on K3; conv3 + residual + ReLU on K2; the head on K1; an
# activation quantize (KQ) before each
RESNEXT_PER_FWD = {"qconv2d_grouped": 16, "qconv2d": 21, "conv1x1_residual": 16,
                   "w8a8_gemm": 1, "quantize_act_int8": 54}
# MobileNetV2 W8A8, BN folded: the stem, 16 expand, 17 project and the head
# 1 x 1 convs on K3, the classifier on K1, KQ before each; the 17 depthwise
# convs take the float path (fake quant, dequantized weight, a float32
# library conv), as in JAX
MOBILENET_PER_FWD = {"qconv2d": 35, "w8a8_gemm": 1, "quantize_act_int8": 36}
# MobileNetV2 W8 weight-only: every conv on the library (quant_conv2d_wo,
# as JAX), the classifier on K5
MOBILENET_WO_PER_FWD = {"wo_gemm": 1}
# WideResNet-28-10 W8A8 at 32 x 32: the stem, the 24 block convs and the 3
# 1 x 1 shortcuts on K3 (the live bn1 BatchNorms between them), the head on
# K1, KQ before each
WRN_PER_FWD = {"qconv2d": 28, "w8a8_gemm": 1, "quantize_act_int8": 29}
# the quant section of tests/golden/models.json's mobile_stack_w8a8 (8-bit
# symmetric per-channel MinMax weights, 8-bit unsigned asymmetric per-tensor
# MinMax activations, BN folded)
CFG_MOBILE = {"default": {
    "weight": {"n_bits": 8, "symmetric": True, "signed": True, "granularity": "channel",
               "range": {"name": "minmax"}},
    "activation": {"n_bits": 8, "symmetric": False, "signed": False, "granularity": "layer",
                   "range": {"name": "minmax"}},
    "bn_folding": True}}
MBV2_W8_CFG = "configs/runners/ptq/minmax/ptq_mbv2_w8only_in1k.yaml"
# CLIP ViT-B/16 W8A8, image tower (S = 197 padded to 200): the patch conv on
# K3, each block's fused q/k/v, c_fc and c_proj on K1, its weight-only
# out-projection on K5, ln_1 and ln_2 fused into their consumers' quantize
# (K7), the attention on K8, KQ before the patch conv and each c_proj;
# ln_pre and ln_post are flax's float LayerNorm (no kernel)
CLIP_VIT_PER_FWD = {"qconv2d": 1, "w8a8_gemm": 36, "wo_gemm": 12, "layernorm_quant_int8": 24,
                    "mha_rows": 12, "quantize_act_int8": 13}
# the text tower's packed pass (S = 77 padded to 80, K8 causal)
CLIP_TEXT_PER_PASS = {"w8a8_gemm": 36, "wo_gemm": 12, "layernorm_quant_int8": 24,
                      "mha_rows": 12, "quantize_act_int8": 12}
# CLIP RN50 W8A8 image tower: the 3 stem convs, 48 block convs and 4
# downsamples on K3 (no fused residual tail: the identity joins after a
# separate ReLU path), the attention pool's q/k/v/c projections on K1, KQ
# before each
CLIP_RN_PER_FWD = {"qconv2d": 55, "w8a8_gemm": 4, "quantize_act_int8": 59}
# configs/datasets/imagenet/prompts.yaml's templates, over 1000 class names
CLIP_CFG = "configs/runners/ptq/clip_vitb16_zeroshot_in1k.yaml"
CLIP_CLASSES = 1000

# the runner phase: the CPU config as users run it (TestCNN, 32 x 32), then
# at 224 x 224 on synthetic images: the same config at ResNet-50's full width,
# as ptq_rn50_w8a8_in1k_16shots.yaml sets its model and quant sections, from
# random weights and from a torchvision checkpoint; ResNet-18 from a
# torchvision checkpoint with the model and quant sections of the
# cross-entropy config (MSE weights and activations, CE on the head's
# activations; W8A8 packed) and of the bias-correction AWQ config (MSE W8
# weight-only, BiasCorrect on every layer, AWQ with q_group_size 128 on the
# head; its packed path reaches no kernel, as in JAX); MobileNetV2 weight-only;
# CLIP ViT-B/16 zero-shot from an OpenAI-CLIP-layout checkpoint with the CLIP
# config's model (the five prompt templates) and quant sections
RUNNER_CFG = "configs/runners/ptq/minmax/ptq_rn18_w8a8_synthetic.yaml"
RUNNER_224 = ["train_dataset.image_size=224", "val_dataset.image_size=224",
              "test_dataset.image_size=224"]
CE_CFG = "configs/runners/ptq/cross_entropy/ptq_rn18_w8a8_bnf_sym_chan_in1k_16shots.yaml"
AWQ_CFG = "configs/runners/ptq/bias_correct/awq.yaml"
# (label, model, config whose model and quant sections replace RUNNER_CFG's,
# torch checkpoint, launches per forward)
RUNNER_RUNS = (("testcnn", "testcnn", None, False, TESTCNN_PER_FWD),
               ("resnet50@224", "resnet50", None, False, RESNET_PER_FWD),
               ("resnet50@224 from a torch checkpoint", "resnet50", None, True, RESNET_PER_FWD),
               ("resnet18@224 cross-entropy", "resnet18", CE_CFG, True, RESNET18_PER_FWD),
               ("resnet18@224 bias-correct + AWQ", "resnet18", AWQ_CFG, True, {}),
               ("mobilenet_v2@224 W8 weight-only from a torch checkpoint", "mobilenet_v2",
                MBV2_W8_CFG, True, MOBILENET_WO_PER_FWD),
               ("clip_vit-b16@224 zero-shot from a CLIP checkpoint", "clip_vit-b16", CLIP_CFG,
                True, CLIP_VIT_PER_FWD))
# phase 7: the ImageNet configs whose model, quant, runner, optimizer and
# schedule sections the training runs take (on seeded synthetic images), the
# base configs the TestCNN runs through the CLI layer on RUNNER_CFG, and the
# TestCNN runs: (label, base config, --opts)
QAT_CFG = "configs/runners/qat/qat_vitb16_w4a8_in1k.yaml"
ADAROUND_CFG = "configs/runners/adaround/adaround_mbv2_w4_in1k.yaml"
TRAIN_CLI_RUNS = (("qat", "configs/runners/qat/base.yaml", []),
                  ("adaround joint", "configs/runners/adaround/base.yaml",
                   ["runner.reconstruction=joint"]),
                  ("adaround sequential", "configs/runners/adaround/base.yaml",
                   ["runner.reconstruction=sequential"]))
# MobileNetV2's AdaRound layers: the stem, 17 depthwise, 16 expand and 17
# project convs, the head conv and the classifier
MOBILENET_ADA_LAYERS = 53
# phase 7's image size and batches: QAT's calibration and training batch,
# AdaRound's cached batch, and the served requests
TRAIN_IMAGE, QAT_BATCH, ADA_BATCH, TRAIN_REQUEST = 224, 64, 32, 128
# torchvision ResNets: (blocks per stage, bottleneck, groups, width per group)
TORCHVISION_RESNETS = {"resnet18": ((2, 2, 2, 2), False, 1, 64),
                       "resnet50": ((3, 4, 6, 3), True, 1, 64),
                       "resnext50_32x4d": ((3, 4, 6, 3), True, 32, 4)}
# torchvision mobilenet_v2: (expand ratio, channels, repeats, stride)
MOBILENET_V2_CFG = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
                    (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1))
VIT_PER_FWD = {"w4a8_gemm": 37, "layernorm_quant_int8": 24, "mha_rows": 12, "layernorm": 1,
               "qconv2d": 1, "wo_gemm": 12, "quantize_act_int8": 14}
VIT32_PER_FWD = {"wo_gemm": 73, "layernorm": 25, "mha_rows": 12}
VIT32_INT8_PER_FWD = {"wo_gemm": 73, "layernorm": 25, "mha_rows_int8": 12}
# (kernel, S, valid rows, dtype, E, heads) of phase 6: the long sequences
# (E 768, 12 heads), head dim 128 at S 856 (E 512, 4 heads), head dims 320
# and 512, and the widest heads the dispatch takes (S = 8: 65,528 in bf16,
# 49,144 in float32)
LONG_SHAPES = (("mha_rows", 488, 485, "bfloat16", 768, 12),
               ("mha_rows", 680, 677, "bfloat16", 768, 12),
               ("mha_rows", 456, 453, "float32", 768, 12),
               ("mha_rows", 856, 853, "bfloat16", 512, 4),
               ("mha_rows_int8", 584, 577, "bfloat16", 768, 12),
               ("mha_rows_int8", 776, 769, "bfloat16", 768, 12),
               ("mha_rows_int8", 856, 853, "bfloat16", 512, 4),
               ("mha_rows", 256, 253, "float32", 320, 1),
               ("mha_rows_int8", 256, 253, "float32", 320, 1),
               ("mha_rows", 400, 397, "bfloat16", 1024, 2),
               ("mha_rows_int8", 400, 397, "bfloat16", 1024, 2),
               ("mha_rows", 8, 5, "bfloat16", 65528, 1),
               ("mha_rows_int8", 8, 5, "bfloat16", 65528, 1),
               ("mha_rows", 8, 5, "float32", 49144, 1),
               ("mha_rows_int8", 8, 5, "float32", 49144, 1))


# (M, K, N, z_w == 0, route) of the K4 phase: ragged M (128, 200, 333), N =
# 1000, K/2 not a multiple of 64 (K 96, 160) with z_w != 0, and K = 200 on
# the mma.sync route
W4A8_SHAPES = ((128, 768, 1000, True, "wgmma"), (200, 768, 1000, False, "wgmma"),
               (200, 96, 1000, False, "wgmma"), (333, 160, 2304, False, "wgmma"),
               (25600, 3072, 768, False, "wgmma"), (200, 200, 1000, False, "mma_sync"),
               (200, 200, 1000, True, "mma_sync"))


# (M, K, N, z_w == 0, route) of the K1 phase: ViT-B/16's W8A8 projections at
# batch 128 (fused qkv, fc1, fc2, out-projection; M = 25,600), ResNet-50's
# head at batch 256 (a cluster of 4 CTAs), one image (M = 1) with z_w != 0,
# a cluster of 8 (K = 4096), ragged N = 28 with K = 48, and K = 40 on the
# mma.sync route
W8A8_SHAPES = ((25600, 768, 2304, True, "wgmma"), (25600, 768, 3072, True, "wgmma"),
               (25600, 3072, 768, True, "wgmma"), (25600, 768, 768, True, "wgmma"),
               (256, 2048, 1000, True, "wgmma"), (1, 2048, 1000, False, "wgmma"),
               (128, 4096, 1000, False, "wgmma"), (333, 48, 28, False, "wgmma"),
               (200, 40, 1000, False, "mma_sync"))
# phase 8: the int8 carry at ResNet-50's and MobileNetV3-Large's batch of
# 256 at 224 x 224. ResNet-50 with the fused tail off: every 1 x 1 conv
# (conv3 too) on K3
CARRY_BATCH = 256
RESNET_UNFUSED_PER_FWD = {"qconv2d": 53, "w8a8_gemm": 1, "quantize_act_int8": 54}
# MobileNetV3-Large W8A8, BN folded: the stem, 14 expand, 15 project, the 16
# squeeze-excite 1 x 1 convs (8 blocks) and the head conv on K3, the two
# dense layers on K1, KQ before each; the 15 depthwise convs on the float
# path. Under the carry the first block's depthwise conv (no expand conv,
# a residual) carries its int8 input and takes K3g (Ci/G = 1, 16 groups,
# the dp4a route), after its own KQ
MNV3_PER_FWD = {"qconv2d": 47, "w8a8_gemm": 2, "quantize_act_int8": 49}
MNV3_CARRY_PER_FWD = {"qconv2d": 47, "qconv2d_grouped": 1, "w8a8_gemm": 2,
                      "quantize_act_int8": 50}
# tests/test_packed.py's unpack round trip config: 8-bit weights only
CFG_W8_ONLY = {"default": {"weight": _weight(8), "activation": {"n_bits": 32},
                           "bn_folding": True}}
# phase 8c: (label, FaultInjector keywords, HealthMonitor keywords, the
# restart's error): a crash mid-epoch 1 (2 steps an epoch), and a NaN loss
# at the first QAT step
FAULT_RUNS = (("crash", {"crash_at": [3]}, {"warmup_steps": 100}, "injected crash"),
              ("nan loss", {"nan_loss_at": [2]}, {}, "TrainingDiverged"))
# the route each served launch must take
SERVED_ROUTE = {"conv1x1_residual": "wgmma", "w4a8_gemm": "wgmma", "w8a8_gemm": "wgmma",
                "layernorm_quant_int8": "vector", "qconv2d_grouped": "wgmma"}


# (N, H, W, Ci, Co, G, k, stride, z_w == 0, out dtype, route) of the K3g
# phase (tests/test_torch_grouped_route.py's GROUPED_SHAPES): the golden
# case's shape (G 2, Ci/G 4), ResNeXt-101 32x8d's widths (Ci/G 8-64, batch
# 32) and 64x4d's G = 64, group widths 1, 2 and 3, asymmetric weights (the
# row-sum term), stride 2 with JAX's asymmetric SAME padding (even H), bf16
# output, more than 64 output channels a group (a group split across
# blocks), a 5 x 5 kernel; then asymmetric weights on the wgmma route at
# Ci/G 4 (stride 2, bf16), 8 (a 1 x 1 kernel, ragged M), 32 and 64, Ci/G 8
# with C = 96, not a multiple of 64 (the dp4a route), and a 5 x 5 kernel at
# Ci/G = Co/G 4 (the wgmma route)
GROUPED_SHAPES = ((2, 8, 8, 8, 12, 2, 3, 1, True, "float32", "dp4a"),
                  (32, 56, 56, 256, 256, 32, 3, 1, True, "float32", "wgmma"),
                  (32, 56, 56, 512, 512, 32, 3, 2, True, "bfloat16", "wgmma"),
                  (32, 28, 28, 1024, 1024, 32, 3, 2, True, "float32", "wgmma"),
                  (32, 7, 7, 2048, 2048, 32, 3, 1, True, "float32", "wgmma"),
                  (32, 28, 28, 256, 256, 64, 3, 1, True, "float32", "wgmma"),
                  (32, 14, 14, 2048, 2048, 64, 3, 1, True, "bfloat16", "wgmma"),
                  (8, 28, 28, 96, 96, 96, 3, 1, False, "float32", "dp4a"),
                  (8, 28, 28, 192, 192, 96, 3, 2, False, "float32", "dp4a"),
                  (8, 29, 29, 288, 576, 96, 3, 2, False, "bfloat16", "dp4a"),
                  (8, 16, 16, 64, 64, 4, 3, 1, False, "float32", "wgmma"),
                  (8, 20, 20, 8, 260, 2, 3, 2, False, "float32", "dp4a"),
                  (8, 22, 22, 20, 30, 5, 5, 2, False, "float32", "dp4a"),
                  (32, 56, 56, 128, 128, 32, 3, 2, False, "bfloat16", "wgmma"),
                  (32, 15, 15, 256, 256, 32, 1, 1, False, "float32", "wgmma"),
                  (8, 28, 28, 1024, 1024, 32, 3, 1, False, "float32", "wgmma"),
                  (8, 14, 14, 2048, 2048, 32, 3, 1, False, "float32", "wgmma"),
                  (8, 28, 28, 96, 96, 12, 3, 1, True, "float32", "dp4a"),
                  (8, 22, 22, 128, 128, 32, 5, 2, False, "float32", "wgmma"))
# a shape K3g refuses before launch (3 x 3 taps over 1,024 input channels
# and 32 output channels a group: the wgmma route takes only Ci/G == Co/G,
# and the dp4a route's smallest tile needs more shared memory than a block
# has)
GROUPED_REFUSED = (1, 4, 4, 2048, 64, 2, 3, 1, True, "float32", "dp4a")


# (M, K, N, residual dtype, output dtype, relu, bias, route) of the K2 phase:
# ragged M (147 = 3 x 49 rows), N = 1000, K = 48 (a multiple of 16, not of
# 32), the wide tails' long K loops (WideResNet-50-2's last stage at batch
# 256, K = 1024, and K = 2048), mixed residual/output dtypes without ReLU or
# bias, and the mma.sync route: K = 40 (not a multiple of 16) and N = 28 in
# bf16 (56-byte rows)
CONV1X1_SHAPES = ((147, 256, 1024, "float32", "float32", True, True, "wgmma"),
                  (200, 512, 1000, "bfloat16", "bfloat16", True, True, "wgmma"),
                  (300, 48, 256, "float32", "float32", True, True, "wgmma"),
                  (12544, 1024, 2048, "float32", "float32", True, True, "wgmma"),
                  (12544, 2048, 2048, "bfloat16", "bfloat16", True, True, "wgmma"),
                  (147, 64, 256, "float32", "bfloat16", False, False, "wgmma"),
                  (147, 64, 256, "bfloat16", "float32", True, False, "wgmma"),
                  (300, 40, 256, "float32", "float32", True, True, "mma_sync"),
                  (147, 64, 28, "bfloat16", "bfloat16", True, True, "mma_sync"))

# phase 9, the serving engine: requests of SERVE_IMAGES seeded uint8 images
# at 224 x 224, batches of SERVE_BATCH, sent by four producer threads (how
# many each sends, and through which call), normalized on the card with
# ImageNet's mean and std (the configs' ``normalize``); the device feed's
# frame pool; ViT-B/16's batch through the engine (two chunks)
SERVE_BATCH = 256
SERVE_IMAGES = 4096
SERVE_IMAGE = 224
SERVE_PRODUCERS = (("submit", 256), ("submit_many", 1280), ("submit_batch", 1280),
                   ("submit_batch", 1280))
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
FRAME_POOL = 512
SERVE_IN_FLIGHT = (4, 16)
SERVE_REPS = 3
VIT_SERVE_BATCH = 128
# phase 9d: the CIFAR-10 runner config, over an archive the script writes
# (data_batch_1..5 and test_batch of CIFAR_PER_FILE images each)
CIFAR_CFG = "configs/runners/ptq/minmax/ptq_rn18_w8a8_cifar10.yaml"
CIFAR_PER_FILE = 1000
DATASET_NAMES = ("cifar10", "cifar100", "cifar10c", "imagenet", "imagenet_a", "imagenet_r",
                 "imagenet_v2", "imagenet_sketch", "imagenet_c")


def log(*args):
    print(*args, flush=True)


class Failure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise Failure(what)


# -- recording the main path's kernel calls ------------------------------------

def _sig(args):
    import torch

    return tuple((tuple(a.shape), str(a.dtype)) if isinstance(a, torch.Tensor) else repr(a)
                 for a in args)


class _Recording:
    """Stands in for a kernel wrapper: records the call, then calls it. The
    wrapper counts its launches on its module-level name, so ``launches``
    reads and writes the wrapper's own counter. With ``every`` each call is
    kept (keyed by its signature and its index), else the first call of each
    signature with the count of its calls."""

    def __init__(self, orig, calls, every=False, errs=None, name=""):
        self.orig, self.calls, self.every = orig, calls, every
        self.errs, self.name = errs, name

    def __call__(self, *args):
        key = (_sig(args), len(self.calls)) if self.every else _sig(args)
        entry = self.calls.setdefault(key, [args, 0])
        entry[1] += 1
        if self.errs is not None:  # held against the plain version there and then
            self.errs.append(compare(self.name, args))
        return self.orig(*args)

    def __getattr__(self, name):  # the wrapper's other counters (K4's routes)
        return getattr(self.orig, name)

    @property
    def launches(self):
        return self.orig.launches

    @launches.setter
    def launches(self, value):
        self.orig.launches = value


class Recorder:
    """Swaps the module-level kernel wrappers the port calls (under every
    name a module imported them) for recorders that keep the first call of
    each distinct signature and count calls; the kernels named in ``every``
    keep every call, and those named in ``compare_each`` compare every call
    with the plain version as it is made (``errs``: its max abs errors),
    keeping no more than its first call of each signature."""

    def __init__(self, every=(), compare_each=()):
        self.every, self.compare_each = every, compare_each
        self.errs = {name: [] for name in compare_each}
        import quantize_tpu_torch.nn.layers as layers
        import quantize_tpu_torch.ops.attention as attention
        import quantize_tpu_torch.ops.layernorm as layernorm
        import quantize_tpu_torch.ops.qconv as qconv
        import quantize_tpu_torch.ops.qconv1x1 as qconv1x1
        import quantize_tpu_torch.ops.qmatmul as qmatmul

        self.sites = {"w8a8_gemm": [(qmatmul, "w8a8_gemm")],
                      "conv1x1_residual": [(qconv1x1, "conv1x1_residual_gemm")],
                      "qconv2d": [(qconv, "qconv2d_int8")],
                      "qconv2d_grouped": [(qconv, "qconv2d_grouped_int8")],
                      "w4a8_gemm": [(qmatmul, "w4a8_gemm")],
                      "layernorm": [(layernorm, "layernorm_rows")],
                      "layernorm_quant_int8": [(layernorm, "layernorm_quant_int8_rows")],
                      "mha_rows": [(attention, "mha_rows")],
                      "wo_gemm": [(qmatmul, "wo_gemm")],
                      "mha_rows_int8": [(attention, "mha_rows_int8")],
                      "quantize_act_int8": [(qmatmul, "quantize_act_int8"),
                                            (layers, "quantize_act_int8"),
                                            (qconv, "quantize_act_int8")]}
        self.calls = {name: {} for name in self.sites}

    def __enter__(self):
        self.saved = []
        for name, sites in self.sites.items():
            for mod, attr in sites:
                orig = getattr(mod, attr)
                self.saved.append((mod, attr, orig))
                setattr(mod, attr, _Recording(orig, self.calls[name], name in self.every,
                                              self.errs.get(name), name))
        return self

    def __exit__(self, *exc):
        for mod, attr, orig in self.saved:
            setattr(mod, attr, orig)


# -- timing and bounds ------------------------------------------------------------

def cuda_ms(fn, reps: int = 5, inner: int = 1, warmup: int = 2) -> float:
    """Median over ``reps`` of CUDA-event time per call, ``inner`` calls each."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def _nbytes(t) -> int:
    import torch

    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _itemsize(dtype) -> int:
    import torch

    return torch.empty((), dtype=dtype).element_size()


def work(name: str, args) -> tuple:
    """(operations, their peak rate, bytes moved once) of one kernel call:
    each input read once, each output written once. The contraction
    kernels' counts are the package's (``ops/_cost.py``, what
    ``profiling.layer_costs`` records)."""
    if name not in ("layernorm", "layernorm_quant_int8", "quantize_act_int8"):
        from quantize_tpu_torch.ops._cost import contraction_work

        ops, bits, nbytes = contraction_work(name, args)
        return ops, {8: PEAK_INT8_OPS, 16: PEAK_BF16, 32: PEAK_F32}[bits], nbytes
    if name == "layernorm":
        x, g, b, _, out_dtype = args
        # float32 ops per element: 2 for the mean, 3 for the variance, 4 for y
        return (9 * x.numel(), PEAK_F32,
                sum(map(_nbytes, (x, g, b))) + x.numel() * _itemsize(out_dtype))
    if name == "layernorm_quant_int8":
        x, g, b = args[:3]
        # as K6, plus divide, subtract, round, two clamps
        return 14 * x.numel(), PEAK_F32, sum(map(_nbytes, (x, g, b))) + x.numel()
    x = args[0]
    # float32 ops per element: divide, subtract, round, two clamps, shift
    return 6 * x.numel(), PEAK_F32, _nbytes(x) + x.numel()


def bound_ms(ops: int, peak: float, nbytes: int) -> tuple:
    t_ops, t_bytes = ops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def library_call(name: str, args):
    """One PyTorch call computing the same function, as the yardstick (never
    called by the port): torch._int_mm plus the epilogue in torch ops (K1,
    K2; K4 on the unpacked weight); a bf16 cuDNN conv on the dequantized
    tensors (K3, and grouped for K3g, the nearest call: torch has no CUDA
    int8 convolution);
    F.layer_norm (K6; plus the quantize ops for K7, no single call does
    both); bf16 ``torch.mm`` with a float32 result on the dequantized weight
    plus the bias (K5; both operands cast to bf16 beforehand);
    F.scaled_dot_product_attention with the key mask, and the causal mask
    where the call is causal (K8, and K9 in bf16);
    ``torch.quantize_per_tensor`` (KQ, the nearest call: round(x / s) + zp
    to a quantized int8 tensor, its scale and zero point taken to the host
    beforehand). None where the library call does not take the shape."""
    import torch
    import torch.nn.functional as F

    if name in ("w8a8_gemm", "conv1x1_residual", "w4a8_gemm"):
        q, z, a_s, w = args[:4]
        if name == "w4a8_gemm":
            w = unpacked_w4(args)
        elif w is None:  # K1 given only the K-major copy
            w = args[9].t().contiguous()
        n = w.shape[1]
        if name == "w8a8_gemm" and n % 8:
            # torch._int_mm takes N a multiple of 8: K1's weight zero-padded
            # to the next multiple of 16 (outside the timed call), the
            # product's extra columns dropped
            w = F.pad(w, (0, -n % 16))
        # cuBLASLt's int8 product refuses K = 40 (seen on an H100): K a multiple of 16
        if q.shape[0] <= 16 or q.shape[1] % 16 or w.shape[1] % 8:
            return None
        if name != "conv1x1_residual":
            _, _, _, _, cs, ws, _, bias = args[:8]
            if w.shape[1] != n:
                # cuBLASLt refuses some padded shapes (K = 48, N 28 -> 32,
                # seen on an H100): probed once, None where it does
                try:
                    torch._int_mm(q, w)
                    torch.cuda.synchronize()
                except RuntimeError as exc:
                    if "CUBLAS_STATUS_NOT_SUPPORTED" not in str(exc):
                        raise
                    return None
            return lambda: (a_s * ws) * (torch._int_mm(q, w)[:, :n].float() + z * cs) + bias
        _, _, _, _, cs, ws, bias, res, relu, out_dtype = args[:10]
        return lambda: torch.relu((a_s * ws) * (torch._int_mm(q, w).float() + z * cs)
                                  + bias + res.float()).to(out_dtype)
    if name in ("qconv2d", "qconv2d_grouped"):
        q, z, a_s, w, ws, wz, bias, strides, pads, corr, _, out_dtype = args[:12]
        groups = args[12] if name == "qconv2d_grouped" else 1
        (pt, pb), (pl, pr) = pads
        x = F.pad(((q.float() + z) * a_s).permute(0, 3, 1, 2), (pl, pr, pt, pb))
        x = x.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
        wd = ((w.float() + wz) * ws).permute(3, 2, 0, 1).to(torch.bfloat16)
        wd = wd.contiguous(memory_format=torch.channels_last)
        b16 = bias.to(torch.bfloat16)
        return lambda: F.conv2d(x, wd, b16, stride=tuple(strides), groups=groups)
    if name == "layernorm":
        x, g, b, eps, out_dtype = args
        gx, bx = g.to(x.dtype), b.to(x.dtype)
        return lambda: F.layer_norm(x, (x.shape[-1],), gx, bx, eps).to(out_dtype)
    if name == "layernorm_quant_int8":
        x, g, b, eps, a_s, a_z, qmin, qmax = args
        gx, bx = g.to(x.dtype), b.to(x.dtype)
        shift = 128.0 if qmin >= 0 else 0.0
        return lambda: (torch.clamp(torch.round(F.layer_norm(x, (x.shape[-1],), gx, bx, eps).float()
                                                / a_s - a_z), qmin, qmax) - shift).to(torch.int8)
    if name == "quantize_act_int8":
        x, scale, zero, qmin, qmax = args
        lo, hi, qdtype = (0, 255, torch.quint8) if qmin >= 0 else (-128, 127, torch.qint8)
        s, zp = float(scale), min(max(int(round(-float(zero))), lo), hi)
        return lambda: torch.quantize_per_tensor(x, s, zp, qdtype)
    if name == "wo_gemm":
        from quantize_tpu_torch.ops.qmatmul import _dequant_weight

        x, w, ws, wz, bias, _ = args
        xb = x.to(torch.bfloat16)
        wb = _dequant_weight(w, ws, wz).to(torch.bfloat16)
        return lambda: torch.mm(xb, wb, out_dtype=torch.float32) + bias
    qkv, heads, s, causal, out_dtype, valid = args
    if name == "mha_rows_int8":
        qkv = qkv.to(torch.bfloat16)
    rows, three_e = qkv.shape
    b, e = rows // s, three_e // 3
    d = e // heads
    q, k, v = qkv.view(b, s, 3, heads, d).permute(2, 0, 3, 1, 4).unbind(0)
    pos = torch.arange(s, device=qkv.device)
    mask = (pos < (valid or s)).reshape(1, 1, 1, s)
    if causal:  # the key mask and the causal mask in one boolean mask
        mask = mask & (pos.reshape(s, 1) >= pos.reshape(1, s))
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, is_causal=False)


def unpacked_w4(args):
    """K4's weight (K, N) int8, unpacked from ``w_p4`` or its K-major copy."""
    from quantize_tpu_torch.ops.qmatmul import unpack_int4_splithalf

    w_p4 = args[3] if args[3] is not None else args[9].t()
    return unpack_int4_splithalf(w_p4).contiguous()


def int_mm_ms(args) -> float:
    """``torch._int_mm`` alone on K4's arguments (the unpacked weight)."""
    import torch

    q, w = args[0], unpacked_w4(args)
    return cuda_ms(lambda: torch._int_mm(q, w), reps=5, inner=10)


def plain_fn(name: str):
    from quantize_tpu_torch.ops.attention import mha_rows_int8_plain, mha_rows_plain
    from quantize_tpu_torch.ops.layernorm import layernorm_plain, layernorm_quant_int8_plain
    from quantize_tpu_torch.ops.qconv import qconv2d_grouped_int8_plain, qconv2d_int8_plain
    from quantize_tpu_torch.ops.qconv1x1 import conv1x1_residual_plain
    from quantize_tpu_torch.ops.qmatmul import (quantize_act_int8_plain, w4a8_gemm_plain,
                                                 w8a8_gemm_plain, wo_gemm_plain)

    return {"w8a8_gemm": w8a8_gemm_plain, "conv1x1_residual": conv1x1_residual_plain,
            "qconv2d": qconv2d_int8_plain, "qconv2d_grouped": qconv2d_grouped_int8_plain,
            "w4a8_gemm": w4a8_gemm_plain,
            "layernorm": layernorm_plain, "layernorm_quant_int8": layernorm_quant_int8_plain,
            "mha_rows": mha_rows_plain, "wo_gemm": wo_gemm_plain,
            "mha_rows_int8": mha_rows_int8_plain,
            "quantize_act_int8": quantize_act_int8_plain}[name]


def kernel_fn(name: str):
    from quantize_tpu_torch.ops import KERNEL_WRAPPERS

    return KERNEL_WRAPPERS[name]


def _ulps_bf16(g, w):
    """|g - w| in bf16 ulps of the larger magnitude (2^(exponent - 7))."""
    import torch

    ulp = torch.exp2(torch.floor(torch.log2(torch.maximum(g.abs(), w.abs()).clamp_min(1e-30))) - 7)
    return float(((g - w).abs() / ulp).max())


def compare(name: str, args) -> float:
    """Run the kernel and its plain version on ``args``; return max|diff|
    and fail outside the kernel's tolerance (module docstring, phase 7)."""
    import torch

    got = kernel_fn(name)(*args)
    want = plain_fn(name)(*args)
    torch.cuda.synchronize()
    if name == "quantize_act_int8":
        (got, z_got), (want, z_want) = got, want
        n_diff = int((got != want).sum())
        log(f"  {name} {describe(name, args)}: {n_diff} of {got.numel()} int8 values differ")
        check(got.dtype == torch.int8 and got.shape == want.shape and n_diff == 0
              and float(z_got) == float(z_want),
              f"{name}: kernel disagrees with its plain version")
        return 0.0
    if name == "layernorm_quant_int8":
        (got, z_got), (want, z_want) = got, want
        check(float(z_got) == float(z_want), f"{name}: z_eff {float(z_got)} != {float(z_want)}")
        step = (got.int() - want.int()).abs()
        n_diff = int((step > 0).sum())
        log(f"  {name} {describe(name, args)}: {n_diff} of {step.numel()} int8 values differ "
            f"(max {int(step.max())} step)")
        check(n_diff == 0, f"{name}: {n_diff} int8 values differ from the plain version")
        return float(step.max())
    check(got.shape == want.shape and got.dtype == want.dtype, f"{name}: shape/dtype mismatch")
    g, w = got.float(), want.float()
    err = float((g - w).abs().max())
    check(bool(torch.isfinite(g).all()), f"{name}: non-finite output")
    if name == "wo_gemm":
        from quantize_tpu_torch.ops.qmatmul import _dequant_weight

        x, w_int, ws, wz, _, cdt = args
        w_c = _dequant_weight(w_int, ws, wz).to(cdt).float()
        sum_abs = (x.to(cdt).float().abs() @ w_c.abs()).clamp_min(1e-30)
        limit = WO_LIMIT * sum_abs + 2.0 ** -23 * w.abs()
        reading = float(((g - w).abs() / sum_abs).max())
        share = float(((g - w).abs() / limit).max())
        # the control: the same product with A left unrounded, as a kernel that
        # skipped A's bf16 rounding would form it; the limit must catch it
        control = float(((x.float() @ w_c + (0 if args[4] is None else args[4]) - w).abs()
                         / limit).max())
        log(f"  {name} {describe(name, args)}: max abs err {err:.3e}, |diff| / sum|a*w| "
            f"{reading:.3e}, {share:.3e} of the limit (A unrounded: {control:.3e} of it)")
        check(share <= 1.0, f"{name}: kernel outside 2^-18 * sum|a*w| + 2^-23 * |out|")
        check(x.dtype == cdt or control > 1.0,
              f"{name}: the limit would not catch an unrounded A at this shape")
        return err
    if name == "mha_rows_int8":
        qkv, heads, s = args[:3]
        b, d = qkv.shape[0] // s, qkv.shape[1] // 3 // heads
        groups = (g - w).abs().reshape(b, s, heads, d).amax(-1)  # (B, S, H)
        sv = qkv.float().reshape(b, s, 3, heads, d)[:, :, 2].abs().amax(dim=(1, 3)) / 127
        n_diff = int((groups > 0).sum())
        log(f"  {name} {describe(name, args)}: {n_diff} of {groups.numel()} (row, head) groups "
            f"differ (ex8 flips), max abs err {err:.3e}")
        check(n_diff <= max(2, 1e-3 * groups.numel())
              and bool((groups <= 2.05 * sv[:, None, :] * (1 + 2.0 ** -7)).all()),
              f"{name}: kernel disagrees with its plain version beyond ex8 flips")
        return err
    if name in ("w8a8_gemm", "w4a8_gemm", "qconv2d", "qconv2d_grouped", "conv1x1_residual"):
        ok = bool(torch.equal(got, want))
    elif got.dtype == torch.bfloat16:
        ok = _ulps_bf16(g, w) <= (2 if name == "mha_rows" else 1)
    else:
        rtol, atol = {"layernorm": (1e-5, 1e-5), "mha_rows": (1e-4, 1e-5)}.get(name, (1e-5, 1e-4))
        ok = bool(((g - w).abs() <= atol + rtol * w.abs()).all())
    check(ok, f"{name}: kernel disagrees with its plain version (max abs err {err})")
    return err


def describe(name: str, args) -> str:
    if name in ("qconv2d", "qconv2d_grouped"):
        q, w, strides = args[0], args[3], args[7]
        groups = f" G={args[12]}" if name == "qconv2d_grouped" else ""
        return (f"x{tuple(q.shape)} w{tuple(w.shape)}{groups} s{tuple(strides)} "
                f"out={str(args[11]).replace('torch.', '')}")
    if name in ("layernorm", "layernorm_quant_int8"):
        return f"x{tuple(args[0].shape)} {str(args[0].dtype).replace('torch.', '')}"
    if name == "quantize_act_int8":
        return (f"x{tuple(args[0].shape)} {str(args[0].dtype).replace('torch.', '')} "
                f"grid [{args[3]}, {args[4]}]")
    if name in ("mha_rows", "mha_rows_int8"):
        return (f"qkv{tuple(args[0].shape)} {str(args[0].dtype).replace('torch.', '')} "
                f"heads={args[1]} S={args[2]} valid={args[5]}")
    if name == "wo_gemm":
        return (f"M={args[0].shape[0]} K={args[0].shape[1]} N={args[1].shape[1]} "
                f"x={str(args[0].dtype).replace('torch.', '')}")
    extra = f" out={str(args[9]).replace('torch.', '')}" if name == "conv1x1_residual" else ""
    return f"M={args[0].shape[0]} K={args[0].shape[1]} N={args[4].shape[0]}{extra}"


def rel(a, b) -> float:
    return float((a.float() - b.float()).abs().max() / b.float().abs().max())


def serve(model, requests, per_fwd: dict, label: str, classes: int = 1000) -> tuple:
    """The main path: counts zeroed just before the requests, read just
    after; every kernel of ``per_fwd`` launched that many times a forward."""
    import torch
    from quantize_tpu_torch.ops import launch_counts, reset_launch_counts

    model(requests[0], mode="packed")  # first call outside the counted run
    torch.cuda.synchronize()
    reset_launch_counts()
    outs = [model(x, mode="packed") for x in requests]
    torch.cuda.synchronize()
    counts = launch_counts()
    log(f"{label}: served {len(requests)} requests of {requests[0].shape[0]} with launches {counts}")
    for name, n in per_fwd.items():
        check(counts[name] == n * len(requests),
              f"{label}: {name}: {counts[name]} launches, expected {n * len(requests)}")
    for name, n in counts.items():
        check(name in per_fwd or n == 0, f"{label}: {name} launched {n} times, expected none")
    for out in outs:
        check(tuple(out.shape) == (requests[0].shape[0], classes) and bool(torch.isfinite(out).all()),
              f"{label}: packed logits not finite or of the wrong shape")
    return outs, counts


def check_routes(name: str, n: int, label: str, route: str = "") -> dict:
    """Every one of the ``n`` launches of kernel ``name`` (K1, K2, K3g, K4 or K7)
    since the counts were zeroed took ``route``, else its ``SERVED_ROUTE``."""
    route = route or SERVED_ROUTE[name]
    routes = dict(kernel_fn(name).route_launches)
    want = {**{r: 0 for r in routes}, route: n}
    log(f"{label}: {name} launches by route {routes}")
    check(routes == want, f"{label}: not every {name} launch took the {route} route: {routes}")
    return routes


def device_ms(fn, match: str, n: int = 20):
    """Device time per call of the kernels whose name contains ``match``
    (torch.profiler over ``n`` calls after a warm-up), or None where the
    profiler saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0)
             for e in prof.key_averages() if match in e.key)
    return us / n / 1e3 if us > 0 else None


def kernel_entries(serve_calls: dict, counts: dict, max_err: dict, names, label: str = "") -> list:
    """Per-launch times of each recorded main-path shape, logged (``label``
    names the model where it is not the JSON's) and summed over one forward
    for the JSON line."""
    entries = []
    for name in names:
        agg = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
               "ops_ms": 0.0, "bytes_ms": 0.0}
        library_ok = True
        for args, per_fwd in serve_calls[name].values():
            ops, peak, nbytes = work(name, args)
            b_ms, b_by = bound_ms(ops, peak, nbytes)
            k_ms = cuda_ms(lambda: kernel_fn(name)(*args), reps=5, inner=10)
            p_ms = cuda_ms(lambda: plain_fn(name)(*args), reps=3, warmup=1)
            lib = library_call(name, args)
            l_ms = cuda_ms(lib, reps=5, inner=5) if lib is not None else None
            library_ok = library_ok and l_ms is not None
            padded = (f" (N padded to {args[4].shape[0] + -args[4].shape[0] % 16})"
                      if name == "w8a8_gemm" and args[4].shape[0] % 8 else "")
            log(f"kernel {name}{label and ' at ' + label} {describe(name, args)}: x{per_fwd}/fwd "
                f"{k_ms:.4f} ms (bound {b_ms:.4f} ms by {b_by}, {b_ms / k_ms:.1%} of it), "
                f"plain {p_ms:.3f} ms, "
                f"library {'n/a' if l_ms is None else f'{l_ms:.4f} ms'}{padded}")
            agg["ms"] += per_fwd * k_ms
            agg["plain_ms"] += per_fwd * p_ms
            agg["bound_ms"] += per_fwd * b_ms
            agg["ops_ms"] += per_fwd * ops / peak * 1e3
            agg["bytes_ms"] += per_fwd * nbytes / PEAK_BYTES * 1e3
            agg["library_ms"] += per_fwd * (l_ms or 0.0)
        src, replaces = KERNEL_INFO[name]
        entries.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": counts[name], "max_abs_err": max_err[name],
            "ms": agg["ms"], "plain_ms": agg["plain_ms"], "bound_ms": agg["bound_ms"],
            "bound_by": "operations" if agg["ops_ms"] >= agg["bytes_ms"] else "bytes",
            "library_ms": agg["library_ms"] if library_ok else None,
        })
    return entries


def check_kernels(calls_list, names, max_err: dict) -> int:
    """Compare every recorded call of ``names`` with the plain version."""
    checks = [(name, args) for calls in calls_list for name in names
              for args, _ in calls[name].values()]
    for name, args in checks:
        max_err[name] = max(max_err.get(name, 0.0), compare(name, args))
    return len(checks)


# -- the phases ----------------------------------------------------------------------

def resnet_phase(qtt, batch, card) -> tuple:
    import torch
    from quantize_tpu_torch.ops import reset_launch_counts

    t0 = time.time()
    model = qtt.MODELS.build("resnet50", num_classes=1000, ctx=qtt.QuantCtx(CFG))
    sample = batch(32)
    qtt.init_model(model, sample, seed=0)
    qtt.calibrate_model(model, [batch(32) for _ in range(4)])
    qtt.pack_model(model, sample)
    torch.cuda.synchronize()
    log(f"resnet50 set-up (init, calibrate 4x32, pack) {time.time() - t0:.1f} s")

    requests = [batch(256) for _ in range(4)]
    with torch.inference_mode(), qtt.fused_residual(True):
        outs, counts = serve(model, requests, RESNET_PER_FWD, "resnet50")
        routes = check_routes("conv1x1_residual", counts["conv1x1_residual"], "resnet50")
        k1_routes = check_routes("w8a8_gemm", counts["w8a8_gemm"], "resnet50")
        x0, packed = requests[0], outs[0]
        sim = model(x0, mode="quant")
        with qtt.fused_residual(False):
            unfused = model(x0, mode="packed")
        reset_launch_counts()
        with qtt.packed_carry(torch.bfloat16):
            packed_bf16 = model(x0, mode="packed")
        torch.cuda.synchronize()
        for name in ("conv1x1_residual", "w8a8_gemm"):
            check_routes(name, RESNET_PER_FWD[name], "resnet50 bf16 carry")
        r_sim, r_fuse, r_bf16 = rel(packed, sim), rel(packed, unfused), rel(packed_bf16, packed)
        log(f"resnet50 agreement (relative to max|logits|): packed vs quant-sim {r_sim:.3e} "
            f"(<= 2e-2), fused vs unfused {r_fuse:.3e} (<= 1e-3), bf16 carry vs f32 {r_bf16:.3e} "
            f"(<= 5e-2)")
        check(r_sim <= 2e-2 and r_fuse <= 1e-3 and r_bf16 <= 5e-2, "resnet50 agreement failed")
        log(f"resnet50 argmax agreement packed vs quant-sim on request 0: "
            f"{float((packed.argmax(-1) == sim.argmax(-1)).float().mean()):.4f}")

        # one request of 256 at each carry: the arguments checked are the
        # ones timed below (f32), and the bf16 carry's
        records = []
        for carry in (torch.float32, torch.bfloat16):
            with qtt.packed_carry(carry), Recorder() as rec:
                model(requests[1], mode="packed")
            records.append(rec.calls)
        max_err = {}
        n = check_kernels(records, ("qconv2d", "conv1x1_residual", "w8a8_gemm",
                                    "quantize_act_int8"), max_err)
        log(f"resnet50 kernels: {n} kernel-vs-plain comparisons passed; max abs err {max_err}")

        times = {}
        for label, carry in (("packed f32 carry", torch.float32),
                             ("packed bf16 carry", torch.bfloat16)):
            with qtt.packed_carry(carry):
                times[label] = cuda_ms(lambda: model(requests[2], mode="packed"))
        times["fp32 forward (yardstick)"] = cuda_ms(lambda: model(requests[2], mode="fp32"))
        for label, ms in times.items():
            log(f"time: resnet50 {label}: {ms:.3f} ms per batch of 256, {256e3 / ms:.1f} img/s "
                f"[{card}]")
        entries = kernel_entries(records[0], counts, max_err,
                                 ("w8a8_gemm", "conv1x1_residual", "qconv2d",
                                  "quantize_act_int8"))
        entries[0]["launches_by_route"] = k1_routes
        entries[1]["launches_by_route"] = routes
        # K1's device time at the head beside its event time (the wrapper's
        # host work is inside the event time of one small launch); one launch
        # a forward, so per launch and per forward alike
        (head, _), = records[0]["w8a8_gemm"].values()
        dev_ms = device_ms(lambda: kernel_fn("w8a8_gemm")(*head), "w8a8")
        entries[0]["device_ms"] = dev_ms
        log(f"kernel w8a8_gemm {describe('w8a8_gemm', head)}: device time "
            f"{'not measured' if dev_ms is None else f'{dev_ms:.4f} ms'} (torch.profiler), event "
            f"time {entries[0]['ms']:.4f} ms [{card}]")
        # K2 at bf16 carry, outside the JSON
        for e in kernel_entries(records[1], counts, max_err, ("conv1x1_residual",), "bf16 carry"):
            log(f"per forward at bf16 carry: {e['name']} {e['ms']:.4f} ms, bound "
                f"{e['bound_ms']:.4f} ms, library {e['library_ms']:.4f} ms [{card}]")
    del model, requests, outs, records
    torch.cuda.empty_cache()
    return entries


def torchvision_state_dict(arch: str, num_classes: int, seed: int) -> dict:
    """A torchvision-layout ResNet, ResNeXt or ``mobilenet_v2`` ``state_dict``
    from a seeded ``torch.Generator`` (on the host): He-normal convs (of
    ``(Co, Ci/G, k, k)`` where grouped), BatchNorms with gamma ~ 1 + 0.1 N(0,
    1), beta and running_mean ~ 0.1 N(0, 1), running_var in [0.5, 1.5] and
    ``num_batches_tracked``, a linear head."""
    import math

    import torch

    g = torch.Generator().manual_seed(seed)
    sd = {}

    def conv(key, co, ci, k):
        sd[f"{key}.weight"] = torch.randn((co, ci, k, k), generator=g) * math.sqrt(2.0 / (ci * k * k))

    def bn(key, c):
        sd[f"{key}.weight"] = 1.0 + 0.1 * torch.randn(c, generator=g)
        sd[f"{key}.bias"] = 0.1 * torch.randn(c, generator=g)
        sd[f"{key}.running_mean"] = 0.1 * torch.randn(c, generator=g)
        sd[f"{key}.running_var"] = 0.5 + torch.rand(c, generator=g)
        sd[f"{key}.num_batches_tracked"] = torch.tensor(1000)

    def head(key, in_ch):
        sd[f"{key}.weight"] = torch.randn((num_classes, in_ch), generator=g) / math.sqrt(in_ch)
        sd[f"{key}.bias"] = 0.01 * torch.randn(num_classes, generator=g)

    if arch == "mobilenet_v2":
        conv("features.0.0", 32, 3, 3)
        bn("features.0.1", 32)
        in_ch, i = 32, 1
        for t, c, n, _ in MOBILENET_V2_CFG:
            for _ in range(n):
                p, hidden, j = f"features.{i}.conv", in_ch * t, 0
                if t != 1:
                    conv(f"{p}.0.0", hidden, in_ch, 1)
                    bn(f"{p}.0.1", hidden)
                    j = 1
                conv(f"{p}.{j}.0", hidden, 1, 3)  # depthwise
                bn(f"{p}.{j}.1", hidden)
                conv(f"{p}.{j + 1}", c, hidden, 1)
                bn(f"{p}.{j + 2}", c)
                in_ch, i = c, i + 1
        conv(f"features.{i}.0", 1280, in_ch, 1)
        bn(f"features.{i}.1", 1280)
        head("classifier.1", 1280)
        return sd

    blocks, bottleneck, groups, width_per_group = TORCHVISION_RESNETS[arch]
    conv("conv1", 64, 3, 7)
    bn("bn1", 64)
    in_ch = 64
    for stage, n_blocks in enumerate(blocks):
        planes = 64 * 2 ** stage
        width = planes * width_per_group // 64 * groups
        out_ch = planes * (4 if bottleneck else 1)
        for b in range(n_blocks):
            p = f"layer{stage + 1}.{b}"
            convs = ([(width, in_ch, 1), (width, width // groups, 3), (out_ch, width, 1)]
                     if bottleneck else [(planes, in_ch, 3), (planes, planes, 3)])
            for i, (co, ci, k) in enumerate(convs, 1):
                conv(f"{p}.conv{i}", co, ci, k)
                bn(f"{p}.bn{i}", co)
            if b == 0 and (stage > 0 or in_ch != out_ch):
                conv(f"{p}.downsample.0", out_ch, in_ch, 1)
                bn(f"{p}.downsample.1", out_ch)
            in_ch = out_ch
    head("fc", in_ch)
    return sd


def clip_state_dict(cfg: dict, image_size: int, seed: int) -> dict:
    """An OpenAI-CLIP-layout ``state_dict`` for a ``CLIP_CONFIGS``-style
    ``cfg`` (a ViT or a ModifiedResNet image tower, the causal text tower)
    from a seeded ``torch.Generator`` (on the host): linears and
    ``in_proj_weight`` ~ N(0, 1/fan_in), He-normal convs, LayerNorms with
    gamma ~ 1 + 0.1 N(0, 1) and beta ~ 0.1 N(0, 1), BatchNorms as
    :func:`torchvision_state_dict`'s, embeddings and projections at the
    reference's init scales, ``logit_scale`` log(1 / 0.07)."""
    import math

    import torch

    g = torch.Generator().manual_seed(seed)
    sd = {}

    def normal(key, shape, std):
        sd[key] = torch.randn(shape, generator=g) * std

    def linear(key, out, inp):
        normal(f"{key}.weight", (out, inp), inp ** -0.5)
        normal(f"{key}.bias", (out,), 0.01)

    def ln(key, c):
        sd[f"{key}.weight"] = 1.0 + 0.1 * torch.randn(c, generator=g)
        normal(f"{key}.bias", (c,), 0.1)

    def conv_bn(conv, bn, co, ci, k):
        normal(f"{conv}.weight", (co, ci, k, k), math.sqrt(2.0 / (ci * k * k)))
        sd[f"{bn}.weight"] = 1.0 + 0.1 * torch.randn(co, generator=g)
        normal(f"{bn}.bias", (co,), 0.1)
        normal(f"{bn}.running_mean", (co,), 0.1)
        sd[f"{bn}.running_var"] = 0.5 + torch.rand(co, generator=g)
        sd[f"{bn}.num_batches_tracked"] = torch.tensor(1000)

    def resblocks(prefix, width, layers):
        for i in range(layers):
            p = f"{prefix}.resblocks.{i}"
            ln(f"{p}.ln_1", width)
            normal(f"{p}.attn.in_proj_weight", (3 * width, width), width ** -0.5)
            normal(f"{p}.attn.in_proj_bias", (3 * width,), 0.01)
            linear(f"{p}.attn.out_proj", width, width)
            ln(f"{p}.ln_2", width)
            linear(f"{p}.mlp.c_fc", 4 * width, width)
            linear(f"{p}.mlp.c_proj", width, 4 * width)

    tw, embed = cfg["transformer_width"], cfg["embed_dim"]
    normal("token_embedding.weight", (cfg["vocab_size"], tw), 0.02)
    normal("positional_embedding", (cfg["context_length"], tw), 0.01)
    resblocks("transformer", tw, cfg["transformer_layers"])
    ln("ln_final", tw)
    normal("text_projection", (tw, embed), tw ** -0.5)
    sd["logit_scale"] = torch.tensor(math.log(1 / 0.07))
    width, layers = cfg["vision_width"], cfg["vision_layers"]
    if isinstance(layers, int):
        patch = cfg["vision_patch_size"]
        normal("visual.conv1.weight", (width, 3, patch, patch), (3 * patch * patch) ** -0.5)
        normal("visual.class_embedding", (width,), width ** -0.5)
        normal("visual.positional_embedding", ((image_size // patch) ** 2 + 1, width),
               width ** -0.5)
        ln("visual.ln_pre", width)
        resblocks("visual.transformer", width, layers)
        ln("visual.ln_post", width)
        normal("visual.proj", (width, embed), width ** -0.5)
        return sd
    stem = ((width // 2, 3), (width // 2, width // 2), (width, width // 2))
    for i, (co, ci) in enumerate(stem, 1):
        conv_bn(f"visual.conv{i}", f"visual.bn{i}", co, ci, 3)
    in_planes = width
    for stage, n_blocks in enumerate(layers):
        planes = width * 2 ** stage
        for b in range(n_blocks):
            p = f"visual.layer{stage + 1}.{b}"
            for i, (co, ci, k) in enumerate(((planes, in_planes, 1), (planes, planes, 3),
                                             (planes * 4, planes, 1)), 1):
                conv_bn(f"{p}.conv{i}", f"{p}.bn{i}", co, ci, k)
            if b == 0 and (stage > 0 or in_planes != planes * 4):
                conv_bn(f"{p}.downsample.0", f"{p}.downsample.1", planes * 4, in_planes, 1)
            in_planes = planes * 4
    side = image_size // 32
    normal("visual.attnpool.positional_embedding", (side * side + 1, width * 32),
           (width * 32) ** -0.5)
    for name, out in (("q_proj", width * 32), ("k_proj", width * 32), ("v_proj", width * 32),
                      ("c_proj", embed)):
        linear(f"visual.attnpool.{name}", out, width * 32)
    return sd


def torchvision_forward(sd: dict, arch: str, x_nchw):
    """An independent float32 forward of a torchvision ResNet, ResNeXt or
    ``mobilenet_v2`` state dict in NCHW, BatchNorms unfolded (eval mode), as
    torchvision computes it."""
    import torch
    import torch.nn.functional as F

    def conv_bn(x, conv, bn, stride, act="relu", groups=1):
        w = sd[f"{conv}.weight"]
        y = F.conv2d(x, w, stride=stride, padding=w.shape[-1] // 2, groups=groups)
        y = F.batch_norm(y, sd[f"{bn}.running_mean"], sd[f"{bn}.running_var"],
                         sd[f"{bn}.weight"], sd[f"{bn}.bias"], training=False, eps=1e-5)
        return {"relu": torch.relu, "relu6": lambda v: torch.clamp(v, 0.0, 6.0),
                None: lambda v: v}[act](y)

    if arch == "mobilenet_v2":
        x = conv_bn(x_nchw, "features.0.0", "features.0.1", 2, "relu6")
        i = 1
        for t, c, n, s in MOBILENET_V2_CFG:
            for r in range(n):
                p, out, j, stride = f"features.{i}.conv", x, 0, s if r == 0 else 1
                if t != 1:
                    out = conv_bn(out, f"{p}.0.0", f"{p}.0.1", 1, "relu6")
                    j = 1
                out = conv_bn(out, f"{p}.{j}.0", f"{p}.{j}.1", stride, "relu6",
                              groups=out.shape[1])
                out = conv_bn(out, f"{p}.{j + 1}", f"{p}.{j + 2}", 1, None)
                x = x + out if stride == 1 and out.shape == x.shape else out
                i += 1
        x = conv_bn(x, f"features.{i}.0", f"features.{i}.1", 1, "relu6")
        return F.linear(x.mean(dim=(2, 3)), sd["classifier.1.weight"], sd["classifier.1.bias"])

    blocks, bottleneck, groups, _ = TORCHVISION_RESNETS[arch]
    x = F.max_pool2d(conv_bn(x_nchw, "conv1", "bn1", 2), 3, 2, 1)
    for stage, n_blocks in enumerate(blocks):
        for b in range(n_blocks):
            p, stride = f"layer{stage + 1}.{b}", 2 if stage > 0 and b == 0 else 1
            if bottleneck:
                out = conv_bn(x, f"{p}.conv1", f"{p}.bn1", 1)
                out = conv_bn(out, f"{p}.conv2", f"{p}.bn2", stride, groups=groups)
                out = conv_bn(out, f"{p}.conv3", f"{p}.bn3", 1, None)
            else:
                out = conv_bn(x, f"{p}.conv1", f"{p}.bn1", stride)
                out = conv_bn(out, f"{p}.conv2", f"{p}.bn2", 1, None)
            if f"{p}.downsample.0.weight" in sd:
                x = conv_bn(x, f"{p}.downsample.0", f"{p}.downsample.1", stride, None)
            x = torch.relu(out + x)
    return F.linear(x.mean(dim=(2, 3)), sd["fc.weight"], sd["fc.bias"])


def runner_config(out_dir, label: str, model: str, source, ckpt) -> list:
    """The CLI's ``--cfg`` files and ``--opts`` of one runner run: where a
    torch checkpoint or another config's sections are used, a second file
    (JSON, which YAML reads) gives the model section, and that config's
    quant section in place of RUNNER_CFG's."""
    from pathlib import Path

    from quantize_tpu_torch.models.manifest import sha256_of
    from quantize_tpu_torch.utils import Config

    opts = [] if model == "testcnn" else RUNNER_224
    if source is None and ckpt is None:
        return ["--cfg", RUNNER_CFG] + (["--opts", f"model.name={model}", *opts] if opts else [])
    section = {"model": {"name": model}}
    if ckpt is not None:
        section["model"].update(torch_checkpoint=str(ckpt),
                                torch_checkpoint_sha256=sha256_of(str(ckpt)))
    if source is not None:
        src = Config()
        src.merge_from_yaml(source)
        check(src.model.name == model, f"runner {label}: {source} is not {model}")
        section["quant"] = {"_replace_": True, **src.quant.to_dict()}
        if src.model.prompts:  # CLIP's zero-shot templates
            section["model"]["prompts"] = list(src.model.prompts)
    extra = Path(out_dir) / "run.yaml"
    extra.write_text(json.dumps(section))
    return ["--cfg", RUNNER_CFG, str(extra), "--opts", *opts]


def runner_phase(qtt, card, dev) -> None:
    """The PTQ runner through the CLI, in-process, on the card (phase 3):
    config chain -> loaders -> init (and the torch checkpoint's import) ->
    one calibration epoch -> quantized val -> checkpoints -> test from the
    best checkpoint, then that checkpoint reloaded, packed and served over
    the test split."""
    import tempfile
    from pathlib import Path

    import torch

    with tempfile.TemporaryDirectory() as ckpt_dir:
        ckpts = {}
        for arch in sorted({m for _, m, _, imported, _ in RUNNER_RUNS if imported}):
            t0 = time.time()
            ckpts[arch] = Path(ckpt_dir) / f"{arch}.pth"
            if arch.startswith("clip_"):
                from quantize_tpu_torch.models.clip.model import CLIP_CONFIGS

                sd, layout = clip_state_dict(CLIP_CONFIGS["ViT-B/16"], 224, seed=5), "OpenAI-CLIP"
            else:
                sd, layout = torchvision_state_dict(arch, 10, seed=5), "torchvision"
            torch.save(sd, ckpts[arch])
            log(f"runner: a {layout}-layout {arch} state dict (seed 5) written in "
                f"{time.time() - t0:.2f} s")
        for label, model_name, source, imported, per_fwd in RUNNER_RUNS:
            runner_run(qtt, card, dev, label, model_name, source,
                       ckpts[model_name] if imported else None, per_fwd)


def runner_run(qtt, card, dev, label: str, model_name: str, source, ckpt, per_fwd: dict) -> None:
    """One run of the runner phase (module docstring, phase 3)."""
    import re
    import tempfile
    from pathlib import Path

    import torch
    import quantize_tpu_torch.runners as runners
    from quantize_tpu_torch import cli
    from quantize_tpu_torch.utils import Config

    built, import_s = [], []
    build_runner = runners.build_runner

    def keep(*args, **kw):
        runner = build_runner(*args, **kw)
        imp = runner._maybe_import_torch_checkpoint

        def timed_import():
            t0 = time.time()
            imp()
            torch.cuda.synchronize()
            import_s.append(time.time() - t0)

        runner._maybe_import_torch_checkpoint = timed_import
        built.append(runner)
        return runner

    with tempfile.TemporaryDirectory() as out_dir:
        argv = runner_config(out_dir, label, model_name, source, ckpt)
        runners.build_runner = keep
        try:
            t0 = time.time()
            cli.main(argv + ["--output-dir", out_dir, "--device", str(dev)])
            torch.cuda.synchronize()
            wall = time.time() - t0
        finally:
            runners.build_runner = build_runner
        out = Path(out_dir)
        for name in ("ckpt_last.pkl", "ckpt_best.pkl", "cfg.yaml", "output.log"):
            check((out / name).exists(), f"runner {label}: {name} was not written")
        found = re.findall(r"test result: \{'top1': ([-+.\deE]+|nan), 'n': (\d+)\}",
                           (out / "output.log").read_text())
        check(len(found) == 1, f"runner {label}: no test result in output.log")
        top1, n_test = float(found[0][0]), int(found[0][1])
        check(0.0 <= top1 <= 100.0 and n_test == 256, f"runner {label}: test top-1 {top1} "
              f"over {n_test} examples")
        log(f"runner {label}: config to test result {wall:.2f} s, test top-1 {top1:.2f}% over "
            f"{n_test} (quant mode) [{card}]")

        runner, = built
        cfg = runner.cfg
        batches = list(runner._prefetch(runner.test_loader))
        clip = model_name.startswith("clip_")
        if clip:
            w = runner.model.get_var("zeroshot", "weights")
            norms = w.norm(dim=0)
            check(tuple(w.shape) == (512, 10) and bool(((norms - 1).abs() < 1e-4).all()),
                  f"runner {label}: the zero-shot weights were not computed")
            log(f"runner {label}: zero-shot weights {tuple(w.shape)} from 10 class names x "
                f"{len(cfg.model.prompts)} prompts")
        if ckpt is not None:
            check(len(import_s) == 1, f"runner {label}: the checkpoint was not imported once")
            log(f"runner {label}: import (load, verify sha256, fold, reset observers) "
                f"{import_s[0]:.3f} s [{card}]")
        if ckpt is not None and not clip:
            # the import against an independent NCHW forward of the state
            # dict with its BatchNorms unfolded
            sd = {k: v.to(dev) for k, v in torch.load(ckpt, weights_only=True).items()}
            x0 = batches[0]["img"]
            with torch.inference_mode():
                fp = runner.model(x0, mode="fp32")
                ref = torchvision_forward(sd, model_name, x0.permute(0, 3, 1, 2).contiguous())
            r_imp = rel(fp, ref)
            log(f"runner {label}: fp32 logits of the imported model vs the NCHW forward of the "
                f"state dict (BN unfolded) {r_imp:.3e} of max|logits| (<= 1e-4)")
            check(r_imp <= 1e-4, f"runner {label}: the imported model's fp32 logits disagree")
            if model_name == "resnet50":
                wrong = Config(cfg.to_dict())
                wrong.model.torch_checkpoint_sha256 = "f" * 64
                try:
                    runners.build_runner(wrong, device=dev).init_variables({"img": x0[:2]})
                except ValueError as exc:
                    check("sha256 mismatch" in str(exc), f"runner {label}: {exc}")
                    log(f"runner {label}: a wrong torch_checkpoint_sha256 raised ValueError")
                else:
                    raise Failure(f"runner {label}: a wrong torch_checkpoint_sha256 did not raise")
        sim = torch.cat([runner.eval_step(b, quantized=True) for b in batches])
        fresh = runners.build_runner(cfg, device=dev)
        fresh.load_checkpoint(cfg.runner.best)
        sim_reloaded = torch.cat([fresh.eval_step(b, quantized=True) for b in batches])
        check(bool(torch.equal(sim, sim_reloaded)),
              f"runner {label}: the reloaded best checkpoint gives other quant-mode logits")
        train_batch = next(runner._prefetch(runner.train_loader))
        qtt.pack_model(fresh.model, train_batch["img"], device=dev)
        with torch.inference_mode(), qtt.fused_residual(True):
            outs, counts = serve(fresh.model, [b["img"] for b in batches], per_fwd,
                                 f"runner {label}", classes=10)
            for name in ("conv1x1_residual", "w8a8_gemm"):
                if name in per_fwd:
                    check_routes(name, counts[name], f"runner {label}")
            packed = torch.cat(outs)
            labels = torch.cat([b["label"] for b in batches])
            valid = labels >= 0
            top1_p = float((packed.argmax(-1) == labels)[valid].float().mean()) * 100
            top1_q = float((sim.argmax(-1) == labels)[valid].float().mean()) * 100
            r_sim = rel(packed, sim)
            if clip:
                # the ViT gate on the image tower's output: a random CLIP's
                # zero-shot logits are exp(logit_scale) times cosines near 0
                # (clip_rn_phase), whose relative reading is printed beside
                x0 = batches[0]["img"]
                r_gate = rel(fresh.model.clip.encode_image(x0, mode="packed"),
                             runner.model.clip.encode_image(x0, mode="quant"))
                what, limit = "image features", 5e-2
                log(f"runner {label}: packed vs quant-mode logits {r_sim:.3e} of max|logits| "
                    f"({float(sim.abs().max()):.4f})")
            else:
                r_gate, what, limit = r_sim, "logits", 2e-2
            log(f"runner {label}: packed vs quant-mode {what} {r_gate:.3e} (<= {limit:g}); test "
                f"top-1 packed {top1_p:.2f}% beside quant {top1_q:.2f}%")
            check(r_gate <= limit, f"runner {label}: packed vs quant-mode agreement failed")
            with Recorder() as rec:
                fresh.model(batches[0]["img"], mode="packed")
            max_err = {}
            n = check_kernels([rec.calls], tuple(per_fwd), max_err)
            log(f"runner {label}: {n} kernel-vs-plain comparisons passed; max abs err {max_err}")
            # the shapes no earlier phase gives the kernels: ResNet-50's
            # 10-class head (K1), all of TestCNN's and ResNet-18's (CLIP's
            # are the CLIP phase's)
            new_shapes = ("w8a8_gemm",) if per_fwd is RESNET_PER_FWD else tuple(per_fwd)
            if (ckpt is None or model_name != "resnet50") and not clip:
                kernel_entries(rec.calls, counts, max_err, new_shapes, f"runner {label}")
            if model_name != "testcnn":
                packed_ms = cuda_ms(lambda: fresh.model(batches[0]["img"], mode="packed"))
        if model_name != "testcnn":
            times = {"packed eval batch of 128 (fused residual)": packed_ms,
                     "quant-mode eval batch of 128": cuda_ms(
                         lambda: fresh.eval_step(batches[0], quantized=True)),
                     # last: a calibration step moves the observers it is timed on;
                     # with the CE and MSE searches it takes seconds: fewer repeats
                     "calibration step, batch of 64": cuda_ms(
                         lambda: runner.train_step(train_batch, 0, 0, 1), reps=3, warmup=1)}
            for what, ms in times.items():
                log(f"time: runner {label} {what}: {ms:.3f} ms [{card}]")
        del runner, fresh, built, batches, outs, sim, sim_reloaded, packed, rec
        torch.cuda.empty_cache()


def build_packed(qtt, batch, name: str, cfg: dict, label: str, classes: int = 1000):
    """``name`` with ``classes`` classes built from ``cfg``, random weights
    from seed 0, calibrated on 4 batches of 32 and packed."""
    import torch

    t0 = time.time()
    model = qtt.MODELS.build(name, num_classes=classes, ctx=qtt.QuantCtx(cfg))
    sample = batch(32)
    qtt.init_model(model, sample, seed=0)
    qtt.calibrate_model(model, [batch(32) for _ in range(4)])
    qtt.pack_model(model, sample)
    torch.cuda.synchronize()
    log(f"{label} set-up (init, calibrate 4x32, pack) {time.time() - t0:.1f} s")
    return model


def where_it_goes(model, x, title: str) -> None:
    """The device time of packed forwards of ``x`` by kernel and group
    (``scripts/profile_torch_port.py``'s trace of 3 forwards)."""
    from scripts.profile_torch_port import profile_calls

    profile_calls(lambda: model(x, mode="packed"), title)


def by_signature(calls: dict) -> dict:
    """A recording that kept every call, regrouped as first call and count
    per signature (what ``kernel_entries`` times)."""
    out = {}
    for (sig, _), (args, n) in calls.items():
        out.setdefault(sig, [args, 0])[1] += n
    return out


def resnext_phase(qtt, batch, card, dev) -> list:
    """ResNeXt-50 32x4d W8A8 (module docstring, phase 2a): imported from a
    torchvision-layout state dict, calibrated, packed and served; every K3g
    call of one recorded forward at each carry against its plain version."""
    import torch
    from quantize_tpu_torch.ops import launch_counts, reset_launch_counts

    t0 = time.time()
    sd = torchvision_state_dict("resnext50_32x4d", 1000, seed=50)
    model = qtt.MODELS.build("resnext50_32x4d", num_classes=1000, ctx=qtt.QuantCtx(CFG))
    sample = batch(32)
    qtt.init_model(model, sample, torch_state_dict=sd, model_name="resnext50_32x4d")
    with torch.inference_mode():
        fp = model(sample, mode="fp32")
        ref = torchvision_forward({k: v.to(dev) for k, v in sd.items()}, "resnext50_32x4d",
                                  sample.permute(0, 3, 1, 2).contiguous())
    r_imp = rel(fp, ref)
    log(f"resnext50_32x4d: fp32 logits of the imported model vs the NCHW forward of the state "
        f"dict (BN unfolded) {r_imp:.3e} of max|logits| (<= 1e-4)")
    check(r_imp <= 1e-4, "resnext50_32x4d: the imported model's fp32 logits disagree")
    qtt.calibrate_model(model, [batch(32) for _ in range(4)])
    qtt.pack_model(model, sample)
    torch.cuda.synchronize()
    log(f"resnext50_32x4d set-up (import, calibrate 4x32, pack) {time.time() - t0:.1f} s")

    requests = [batch(256) for _ in range(4)]
    with torch.inference_mode(), qtt.fused_residual(True):
        outs, counts = serve(model, requests, RESNEXT_PER_FWD, "resnext50_32x4d")
        k3g_routes = check_routes("qconv2d_grouped", counts["qconv2d_grouped"], "resnext50_32x4d")
        for name in ("conv1x1_residual", "w8a8_gemm"):
            check_routes(name, counts[name], "resnext50_32x4d")
        x0, packed = requests[0], outs[0]
        sim = model(x0, mode="quant")
        reset_launch_counts()
        with qtt.packed_carry(torch.bfloat16):
            packed_bf16 = model(x0, mode="packed")
        torch.cuda.synchronize()
        check(launch_counts() == {**{k: 0 for k in launch_counts()}, **RESNEXT_PER_FWD},
              f"resnext50_32x4d bf16 carry: launches {launch_counts()}")
        check_routes("qconv2d_grouped", RESNEXT_PER_FWD["qconv2d_grouped"],
                     "resnext50_32x4d bf16 carry")
        r_sim, r_bf16 = rel(packed, sim), rel(packed_bf16, packed)
        log(f"resnext50_32x4d agreement (relative to max|logits|): packed vs quant-sim "
            f"{r_sim:.3e} (<= 2e-2), bf16 carry vs f32 {r_bf16:.3e} (<= 5e-2); argmax agreement "
            f"packed vs quant-sim {float((packed.argmax(-1) == sim.argmax(-1)).float().mean()):.4f}")
        check(r_sim <= 2e-2 and r_bf16 <= 5e-2, "resnext50_32x4d agreement failed")
        del sim, packed_bf16

        # every K3g call of one forward at each carry (16 each), the other
        # kernels at each signature
        records = []
        for carry in (torch.float32, torch.bfloat16):
            with qtt.packed_carry(carry), Recorder(every=("qconv2d_grouped",)) as rec:
                model(requests[1], mode="packed")
            check(len(rec.calls["qconv2d_grouped"]) == RESNEXT_PER_FWD["qconv2d_grouped"],
                  f"resnext50_32x4d: {len(rec.calls['qconv2d_grouped'])} K3g calls recorded")
            records.append(rec.calls)
        max_err = {}
        n = check_kernels(records, tuple(RESNEXT_PER_FWD), max_err)
        log(f"resnext50_32x4d kernels: {n} kernel-vs-plain comparisons passed (every K3g call, "
            f"16 a forward at each carry, bit-equal); max abs err {max_err}")

        times = {}
        for label, carry in (("packed f32 carry", torch.float32),
                             ("packed bf16 carry", torch.bfloat16)):
            with qtt.packed_carry(carry):
                times[label] = cuda_ms(lambda: model(requests[2], mode="packed"))
        times["fp32 forward (yardstick)"] = cuda_ms(lambda: model(requests[2], mode="fp32"))
        for label, ms in times.items():
            log(f"time: resnext50_32x4d {label}: {ms:.3f} ms per batch of 256, "
                f"{256e3 / ms:.1f} img/s [{card}]")
        entries = kernel_entries({"qconv2d_grouped": by_signature(records[0]["qconv2d_grouped"])},
                                 counts, max_err, ("qconv2d_grouped",))
        entries[0]["launches_by_route"] = k3g_routes
        # K3 and K2 at ResNeXt's widths, outside the JSON
        kernel_entries(records[0], counts, max_err, ("qconv2d", "conv1x1_residual"),
                       "resnext50_32x4d")
        where_it_goes(model, requests[2], f"resnext50_32x4d packed, batch 256, f32 carry [{card}]")
    del model, requests, outs, records
    torch.cuda.empty_cache()
    return entries


def mobilenet_phase(qtt, batch, card) -> None:
    """MobileNetV2 W8A8 (module docstring, phase 2c): random weights, served
    at 224; its depthwise convs take the float path (no kernel)."""
    import torch
    from quantize_tpu_torch.ops import launch_counts, reset_launch_counts

    model = build_packed(qtt, batch, "mobilenet_v2", CFG_MOBILE, "mobilenet_v2 W8A8")
    requests = [batch(256) for _ in range(4)]
    with torch.inference_mode():
        outs, counts = serve(model, requests, MOBILENET_PER_FWD, "mobilenet_v2")
        check_routes("w8a8_gemm", counts["w8a8_gemm"], "mobilenet_v2")
        x0, packed = requests[0], outs[0]
        sim = model(x0, mode="quant")
        reset_launch_counts()
        with qtt.packed_carry(torch.bfloat16):
            packed_bf16 = model(x0, mode="packed")
        torch.cuda.synchronize()
        check(launch_counts() == {**{k: 0 for k in launch_counts()}, **MOBILENET_PER_FWD},
              f"mobilenet_v2 bf16 carry: launches {launch_counts()}")
        r_sim, r_bf16 = rel(packed, sim), rel(packed_bf16, packed)
        log(f"mobilenet_v2 agreement (relative to max|logits|): packed vs quant-sim {r_sim:.3e} "
            f"(<= 2e-2), bf16 carry vs f32 {r_bf16:.3e} (<= 5e-2); argmax agreement packed vs "
            f"quant-sim {float((packed.argmax(-1) == sim.argmax(-1)).float().mean()):.4f}")
        check(r_sim <= 2e-2 and r_bf16 <= 5e-2, "mobilenet_v2 agreement failed")
        del sim, packed_bf16
        records = []
        for carry in (torch.float32, torch.bfloat16):
            with qtt.packed_carry(carry), Recorder() as rec:
                model(requests[1], mode="packed")
            records.append(rec.calls)
        max_err = {}
        n = check_kernels(records, tuple(MOBILENET_PER_FWD), max_err)
        log(f"mobilenet_v2 kernels: {n} kernel-vs-plain comparisons passed; max abs err {max_err}")
        times = {}
        for label, carry in (("packed f32 carry", torch.float32),
                             ("packed bf16 carry", torch.bfloat16)):
            with qtt.packed_carry(carry):
                times[label] = cuda_ms(lambda: model(requests[2], mode="packed"))
        times["fp32 forward (yardstick)"] = cuda_ms(lambda: model(requests[2], mode="fp32"))
        for label, ms in times.items():
            log(f"time: mobilenet_v2 {label}: {ms:.3f} ms per batch of 256, {256e3 / ms:.1f} img/s "
                f"[{card}]")
        kernel_entries(records[0], counts, max_err, ("qconv2d", "quantize_act_int8"),
                       "mobilenet_v2")
        where_it_goes(model, requests[2], f"mobilenet_v2 packed, batch 256, f32 carry [{card}]")
    del model, requests, outs, records
    torch.cuda.empty_cache()


def wrn_phase(qtt, card, dev) -> None:
    """WideResNet-28-10 W8A8 at 32 x 32 (module docstring, phase 2d)."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(28)

    def batch(n):
        return torch.randn((n, 32, 32, 3), generator=gen, device=dev)

    model = build_packed(qtt, batch, "wideresnet28", CFG, "wideresnet28 W8A8", classes=10)
    requests = [batch(256) for _ in range(4)]
    with torch.inference_mode():
        outs, counts = serve(model, requests, WRN_PER_FWD, "wideresnet28", classes=10)
        x0, packed = requests[0], outs[0]
        sim = model(x0, mode="quant")
        r_sim = rel(packed, sim)
        log(f"wideresnet28 agreement (relative to max|logits|): packed vs quant-sim {r_sim:.3e} "
            f"(<= 2e-2); argmax agreement "
            f"{float((packed.argmax(-1) == sim.argmax(-1)).float().mean()):.4f}")
        check(r_sim <= 2e-2, "wideresnet28 agreement failed")
        with Recorder() as rec:
            model(requests[1], mode="packed")
        max_err = {}
        n = check_kernels([rec.calls], tuple(WRN_PER_FWD), max_err)
        log(f"wideresnet28 kernels: {n} kernel-vs-plain comparisons passed; max abs err {max_err}")
        times = {"packed f32 carry": cuda_ms(lambda: model(requests[2], mode="packed")),
                 "fp32 forward (yardstick)": cuda_ms(lambda: model(requests[2], mode="fp32"))}
        for label, ms in times.items():
            log(f"time: wideresnet28 {label}: {ms:.3f} ms per batch of 256, {256e3 / ms:.1f} img/s "
                f"[{card}]")
        kernel_entries(rec.calls, counts, max_err, ("qconv2d",), "wideresnet28")
    del model, requests, outs, rec
    torch.cuda.empty_cache()


def grouped_args(shape, dev, gen):
    """K3g's arguments on random operands at ``shape`` (``GROUPED_SHAPES``)."""
    import torch
    from quantize_tpu_torch.ops.qconv import (conv_zero_correction_map, grouped_kernel_weight,
                                              resolve_padding)

    n, h, w, ci, co, g, k, s, wz0, dt, _ = shape
    q = torch.randint(-128, 128, (n, h, w, ci), generator=gen, device=dev, dtype=torch.int8)
    w_int = torch.randint(-127, 128, (k, k, ci // g, co), generator=gen, device=dev,
                          dtype=torch.int8)
    pads = resolve_padding("SAME", k, k, h, w, (s, s))
    w_zero = torch.zeros(co, device=dev) if wz0 else torch.randn(co, generator=gen, device=dev)
    return (q, torch.tensor(131.0, device=dev), torch.tensor(0.0123, device=dev), w_int,
            torch.rand(co, generator=gen, device=dev) * 0.01, w_zero,
            torch.randn(co, generator=gen, device=dev), (s, s), pads,
            conv_zero_correction_map(w_int, h, w, (s, s), pads), wz0, getattr(torch, dt), g,
            grouped_kernel_weight(w_int, g))


def grouped_phase(dev, card) -> int:
    """K3g on random operands at the shapes no model above gives it
    (``GROUPED_SHAPES``, module docstring, phase 2b), each on the route its
    shape selects (both routes run), bit for bit against the plain version,
    with its time beside its bound and the library call's; then a shape it
    refuses (``GROUPED_REFUSED``) raises ValueError by name before launch."""
    import torch
    from quantize_tpu_torch.ops import launch_counts, reset_launch_counts
    from quantize_tpu_torch.ops.qconv import qconv2d_grouped_int8

    gen = torch.Generator(device=dev).manual_seed(3)
    taken = set()
    for shape in GROUPED_SHAPES:
        args = grouped_args(shape, dev, gen)
        reset_launch_counts()
        compare("qconv2d_grouped", args)
        took = [r for r, c in qconv2d_grouped_int8.route_launches.items() if c]
        check(took == [shape[-1]], f"qconv2d_grouped at {shape}: route {took}, expected "
              f"{shape[-1]}")
        taken.add(shape[-1])
        ops, peak, nbytes = work("qconv2d_grouped", args)
        b_ms, b_by = bound_ms(ops, peak, nbytes)
        k_ms = cuda_ms(lambda: qconv2d_grouped_int8(*args), reps=5, inner=10)
        lib = library_call("qconv2d_grouped", args)
        l_ms = cuda_ms(lib, reps=5, inner=5)
        log(f"kernel qconv2d_grouped {describe('qconv2d_grouped', args)} z_w "
            f"{'= 0' if shape[8] else '!= 0'}: route {shape[-1]}, bit-equal, {k_ms:.4f} ms "
            f"(bound {b_ms:.4f} ms by {b_by}, {b_ms / k_ms:.1%} of it), library {l_ms:.4f} ms "
            f"[{card}]")
    check(taken == {"wgmma", "dp4a"}, f"qconv2d_grouped: routes run {taken}, expected both")
    args = grouped_args(GROUPED_REFUSED, dev, gen)
    reset_launch_counts()
    try:
        qconv2d_grouped_int8(*args)
    except ValueError as exc:
        check("qconv2d_grouped_int8" in str(exc) and launch_counts()["qconv2d_grouped"] == 0,
              f"qconv2d_grouped: the refusal of {GROUPED_REFUSED} raised {exc}")
        log(f"qconv2d_grouped at {GROUPED_REFUSED}: refused before launch ({exc})")
    else:
        raise Failure(f"qconv2d_grouped at {GROUPED_REFUSED}: launched, expected a refusal")
    torch.cuda.empty_cache()
    return len(GROUPED_SHAPES) + 1


def vit_phase(qtt, batch, card) -> tuple:
    import torch
    from quantize_tpu_torch.ops import reset_launch_counts

    model = build_packed(qtt, batch, "vit_b_16", CFG_W4A8, "vit_b_16 W4A8")
    requests = [batch(128) for _ in range(4)]
    with torch.inference_mode():
        outs, counts = serve(model, requests, VIT_PER_FWD, "vit_b_16")
        routes = check_routes("w4a8_gemm", counts["w4a8_gemm"], "vit_b_16")
        ln_routes = check_routes("layernorm_quant_int8", counts["layernorm_quant_int8"],
                                 "vit_b_16")
        x0, packed = requests[0], outs[0]
        sim = model(x0, mode="quant")
        reset_launch_counts()
        with qtt.packed_carry(torch.bfloat16):
            packed_bf16 = model(x0, mode="packed")
        torch.cuda.synchronize()
        check_routes("layernorm_quant_int8", VIT_PER_FWD["layernorm_quant_int8"],
                     "vit_b_16 bf16 carry")
        r_sim, r_bf16 = rel(packed, sim), rel(packed_bf16, packed)
        log(f"vit_b_16 agreement (relative to max|logits|): packed vs quant-sim {r_sim:.3e} "
            f"(<= 5e-2), bf16 carry vs f32 {r_bf16:.3e} (<= 5e-2)")
        check(r_sim <= 5e-2 and r_bf16 <= 5e-2, "vit_b_16 agreement failed")
        log(f"vit_b_16 argmax agreement packed vs quant-sim on request 0: "
            f"{float((packed.argmax(-1) == sim.argmax(-1)).float().mean()):.4f}")
        del sim, packed_bf16

        names = ("w4a8_gemm", "layernorm", "layernorm_quant_int8", "mha_rows")
        max_err = {}
        n = 0
        serve_calls = None
        attn_calls = {}
        for carry in (torch.float32, torch.bfloat16):
            with qtt.packed_carry(carry), Recorder() as rec:
                model(requests[1], mode="packed")
            # K3 too: the patch embedding gives it a shape of its own; K5 at
            # the out-projections
            n += check_kernels([rec.calls], names + ("qconv2d", "wo_gemm", "quantize_act_int8"),
                               max_err)
            # K9 on K8's arguments: S = 200, valid 197
            n += check_kernels([{"mha_rows_int8": rec.calls["mha_rows"]}], ("mha_rows_int8",),
                               max_err)
            attn_calls.update(rec.calls["mha_rows"])
            if carry == torch.float32:
                serve_calls = rec.calls
            del rec
        log(f"vit_b_16 kernels: {n} kernel-vs-plain comparisons passed; max abs err {max_err}")

        times = {}
        for label, carry in (("packed f32 carry", torch.float32),
                             ("packed bf16 carry", torch.bfloat16)):
            with qtt.packed_carry(carry):
                times[label] = cuda_ms(lambda: model(requests[2], mode="packed"))
        times["fp32 forward (yardstick)"] = cuda_ms(lambda: model(requests[2], mode="fp32"))
        for label, ms in times.items():
            log(f"time: vit_b_16 {label}: {ms:.3f} ms per batch of 128, {128e3 / ms:.1f} img/s "
                f"[{card}]")
        entries = kernel_entries(serve_calls, counts, max_err, names)
        entries[0]["launches_by_route"] = routes
        entries[2]["launches_by_route"] = ln_routes
        # K7's device time a forward beside its event time (its wrapper's host
        # work is longer than its launch at this shape)
        (ln_args, ln_per_fwd), = serve_calls["layernorm_quant_int8"].values()
        dev_ms = device_ms(lambda: kernel_fn("layernorm_quant_int8")(*ln_args), "ln_q")
        entries[2]["device_ms"] = None if dev_ms is None else dev_ms * ln_per_fwd
        log(f"kernel layernorm_quant_int8 {describe('layernorm_quant_int8', ln_args)}: device "
            f"time {'not measured' if dev_ms is None else f'{dev_ms:.4f} ms'} a launch "
            f"(torch.profiler), event time {entries[2]['ms'] / ln_per_fwd:.4f} ms [{card}]")
        for args, per_fwd in serve_calls["w4a8_gemm"].values():
            log(f"  torch._int_mm alone at {describe('w4a8_gemm', args)}: {int_mm_ms(args):.4f} ms "
                f"(x{per_fwd}/fwd)")
        # K5, K9 and KQ at ViT-B/16's shapes, outside the JSON
        kernel_entries({**serve_calls, "mha_rows_int8": attn_calls}, counts, max_err,
                       ("wo_gemm", "mha_rows_int8", "quantize_act_int8"), "vit_b_16")
    del model, requests, outs, serve_calls, attn_calls
    torch.cuda.empty_cache()
    return entries, max_err


def vit32_phase(qtt, batch, card, prior_err: dict) -> list:
    import os

    import torch
    from quantize_tpu_torch.ops import launch_counts, reset_launch_counts

    model = build_packed(qtt, batch, "vit_b_32", CFG_WO, "vit_b_32 W4 weight-only")
    requests = [batch(256) for _ in range(4)]
    with torch.inference_mode():
        outs, counts = serve(model, requests, VIT32_PER_FWD, "vit_b_32")
        x0, packed = requests[0], outs[0]
        sim = model(x0, mode="quant")
        with qtt.packed_carry(torch.bfloat16):
            packed_bf16 = model(x0, mode="packed")
        r_sim, r_bf16 = rel(packed, sim), rel(packed_bf16, packed)
        log(f"vit_b_32 agreement (relative to max|logits|): packed vs quant-sim {r_sim:.3e} "
            f"(<= 5e-2), bf16 carry vs f32 {r_bf16:.3e} (<= 5e-2)")
        check(r_sim <= 5e-2 and r_bf16 <= 5e-2, "vit_b_32 agreement failed")
        log(f"vit_b_32 argmax agreement packed vs quant-sim on request 0: "
            f"{float((packed.argmax(-1) == sim.argmax(-1)).float().mean()):.4f}")
        del sim, packed_bf16

        # the int8-scores attention: one request again, QTPU_ATTN_INT8=1
        saved_env = os.environ.get("QTPU_ATTN_INT8")
        os.environ["QTPU_ATTN_INT8"] = "1"
        try:
            reset_launch_counts()
            int8_out = model(x0, mode="packed")
            torch.cuda.synchronize()
            int8_counts = launch_counts()
            from quantize_tpu_torch.ops.attention import mha_rows_int8

            prepass = mha_rows_int8.absmax_launches
            log(f"vit_b_32 with QTPU_ATTN_INT8=1: one request of {x0.shape[0]} with launches "
                f"{int8_counts}; K9's absmax pre-pass {prepass} (its resident layout needs "
                f"none)")
            for name, n in int8_counts.items():
                check(n == VIT32_INT8_PER_FWD.get(name, 0),
                      f"vit_b_32 int8 scores: {name} launched {n} times, expected "
                      f"{VIT32_INT8_PER_FWD.get(name, 0)}")
            check(tuple(int8_out.shape) == (x0.shape[0], 1000)
                  and bool(torch.isfinite(int8_out).all()), "vit_b_32 int8 logits not finite")
            r_int8 = rel(int8_out, packed)
            same = float((int8_out.argmax(-1) == packed.argmax(-1)).float().mean())
            log(f"vit_b_32 agreement: int8-scores forward vs the default {r_int8:.3e} (<= 5e-2); "
                f"argmax agreement {same:.4f}")
            check(r_int8 <= 5e-2, "vit_b_32 int8-scores agreement failed")
            int8_records = []
            for carry in (torch.float32, torch.bfloat16):
                with qtt.packed_carry(carry), Recorder() as rec:
                    model(requests[1], mode="packed")
                int8_records.append(rec.calls)
            int8_ms = cuda_ms(lambda: model(requests[2], mode="packed"))
        finally:
            if saved_env is None:
                del os.environ["QTPU_ATTN_INT8"]
            else:
                os.environ["QTPU_ATTN_INT8"] = saved_env

        max_err = dict(prior_err)
        records = []
        for carry in (torch.float32, torch.bfloat16):
            with qtt.packed_carry(carry), Recorder() as rec:
                model(requests[1], mode="packed")
            records.append(rec.calls)
        n = check_kernels(records, ("wo_gemm", "layernorm", "mha_rows"), max_err)
        n += check_kernels(int8_records, ("mha_rows_int8",), max_err)
        log(f"vit_b_32 kernels: {n} kernel-vs-plain comparisons passed; max abs err "
            f"{ {k: max_err[k] for k in ('wo_gemm', 'layernorm', 'mha_rows', 'mha_rows_int8')} }")

        times = {}
        for label, carry in (("packed f32 carry", torch.float32),
                             ("packed bf16 carry", torch.bfloat16)):
            with qtt.packed_carry(carry):
                times[label] = cuda_ms(lambda: model(requests[2], mode="packed"))
        times["packed f32 carry, int8 scores"] = int8_ms
        times["fp32 forward (yardstick)"] = cuda_ms(lambda: model(requests[2], mode="fp32"))
        for label, ms in times.items():
            log(f"time: vit_b_32 {label}: {ms:.3f} ms per batch of 256, {256e3 / ms:.1f} img/s "
                f"[{card}]")
        entries = kernel_entries(records[0], counts, max_err, ("wo_gemm",))
        entries += kernel_entries(int8_records[0], int8_counts, max_err, ("mha_rows_int8",))
        # K9's streamed layout launches an absmax pre-pass of its own
        entries[-1]["absmax_prepass_launches"] = prepass
        for e in kernel_entries(records[0], counts, max_err, ("layernorm", "mha_rows"), "vit_b_32"):
            log(f"per forward at vit_b_32: {e['name']} {e['ms']:.4f} ms ({e['launches'] // 4} "
                f"launches), bound {e['bound_ms']:.4f} ms, library {e['library_ms']:.4f} ms "
                f"[{card}]")
    del model, requests, outs, records, int8_records
    torch.cuda.empty_cache()
    return entries


def clip_tokens():
    """(1000, 5, 77) int32 prompt tokens: ``CLIP_CLASSES`` class names times
    the config's five templates, through the hash tokenizer over CLIP's
    vocabulary of 49,408."""
    from quantize_tpu_torch.models.clip import HashTokenizer, class_prompt_tokens
    from quantize_tpu_torch.utils import Config

    src = Config()
    src.merge_from_yaml(CLIP_CFG)
    return class_prompt_tokens([f"class {i}" for i in range(CLIP_CLASSES)],
                               list(src.model.prompts), HashTokenizer(49408), 77)


def clip_phase(qtt, batch, card, dev) -> None:
    """CLIP ViT-B/16 W8A8 (module docstring, phase 5a): the image tower
    packed and served, then the text tower calibrated, packed and run
    packed over the 5,000 prompts, every causal K8 call of one packed pass
    held against its plain version as it is made."""
    import torch
    from quantize_tpu_torch.ops import launch_counts, reset_launch_counts

    t0 = time.time()
    model = qtt.MODELS.build("clip_vit-b16", num_classes=CLIP_CLASSES, ctx=qtt.QuantCtx(CFG))
    sample = batch(32)
    qtt.init_model(model, sample, seed=0)
    qtt.calibrate_model(model, [batch(32) for _ in range(4)])
    toks = clip_tokens()
    n_prompts = toks.shape[0] * toks.shape[1]
    t1 = time.time()
    model.precompute(toks, mode="fp32")  # the runner's way: the float text tower
    torch.cuda.synchronize()
    fp32_text_s = time.time() - t1
    qtt.pack_model(model, sample)
    torch.cuda.synchronize()
    log(f"clip_vit-b16 W8A8 set-up (init, calibrate 4x32, fp32 zero-shot weights over "
        f"{n_prompts} prompts in {fp32_text_s:.2f} s, pack) {time.time() - t0:.1f} s")
    requests = [batch(128) for _ in range(4)]
    max_err = {}
    with torch.inference_mode():
        outs, counts = serve(model, requests, CLIP_VIT_PER_FWD, "clip_vit-b16",
                             classes=CLIP_CLASSES)
        for name in ("w8a8_gemm", "layernorm_quant_int8"):
            check_routes(name, counts[name], "clip_vit-b16")
        x0, packed = requests[0], outs[0]
        sim = model(x0, mode="quant")
        reset_launch_counts()
        with qtt.packed_carry(torch.bfloat16):
            packed_bf16 = model(x0, mode="packed")
        torch.cuda.synchronize()
        check(launch_counts() == {**{k: 0 for k in launch_counts()}, **CLIP_VIT_PER_FWD},
              f"clip_vit-b16 bf16 carry: launches {launch_counts()}")
        r_sim, r_bf16 = rel(packed, sim), rel(packed_bf16, packed)
        r_emb = rel(model.clip.encode_image(x0, mode="packed"),
                    model.clip.encode_image(x0, mode="quant"))
        log(f"clip_vit-b16 agreement (relative to max|logits|): packed vs quant-sim {r_sim:.3e} "
            f"(<= 5e-2), bf16 carry vs f32 {r_bf16:.3e} (<= 5e-2); argmax agreement packed vs "
            f"quant-sim {float((packed.argmax(-1) == sim.argmax(-1)).float().mean()):.4f}; image "
            f"features packed vs quant-sim {r_emb:.3e} of max|feature|")
        check(r_sim <= 5e-2 and r_bf16 <= 5e-2, "clip_vit-b16 agreement failed")
        del sim, packed_bf16
        records = []
        for carry in (torch.float32, torch.bfloat16):
            with qtt.packed_carry(carry), Recorder() as rec:
                model(requests[1], mode="packed")
            records.append(rec.calls)
        n = check_kernels(records, tuple(CLIP_VIT_PER_FWD), max_err)
        log(f"clip_vit-b16 image tower kernels: {n} kernel-vs-plain comparisons passed; max abs "
            f"err {max_err}")
        times = {}
        for label, carry in (("packed f32 carry", torch.float32),
                             ("packed bf16 carry", torch.bfloat16)):
            with qtt.packed_carry(carry):
                times[label] = cuda_ms(lambda: model(requests[2], mode="packed"))
        times["fp32 forward (yardstick)"] = cuda_ms(lambda: model(requests[2], mode="fp32"))
        for label, ms in times.items():
            log(f"time: clip_vit-b16 image tower {label}: {ms:.3f} ms per batch of 128, "
                f"{128e3 / ms:.1f} img/s [{card}]")
        where_it_goes(model, requests[2], f"clip_vit-b16 image tower packed, batch 128, f32 "
                      f"carry [{card}]")
        del records, outs

    # the text tower: calibrate, quant, pack, then its packed pass (K8 causal)
    t0 = time.time()
    model.precompute(toks, mode="calibrate")
    quant_emb = model.precompute(toks, mode="quant")
    model.precompute(toks, mode="pack")
    torch.cuda.synchronize()
    log(f"clip_vit-b16 text tower: calibrate, quant and pack passes over {n_prompts} prompts "
        f"{time.time() - t0:.1f} s")
    with torch.inference_mode():
        model.precompute(toks, mode="packed")  # first call outside the counted run
        torch.cuda.synchronize()
        reset_launch_counts()
        packed_emb = model.precompute(toks, mode="packed")
        torch.cuda.synchronize()
        counts = launch_counts()
        log(f"clip_vit-b16 text tower: one packed pass over {n_prompts} prompts with launches "
            f"{counts}")
        for name, c in counts.items():
            check(c == CLIP_TEXT_PER_PASS.get(name, 0),
                  f"clip text tower: {name} launched {c} times, expected "
                  f"{CLIP_TEXT_PER_PASS.get(name, 0)}")
        for name in ("w8a8_gemm", "layernorm_quant_int8"):
            check_routes(name, counts[name], "clip_vit-b16 text tower")
        weights = model.get_var("zeroshot", "weights")
        err = float((packed_emb - quant_emb).abs().max())
        check(tuple(weights.shape) == (512, CLIP_CLASSES) and bool(torch.isfinite(weights).all()),
              "clip text tower: zero-shot weights not finite or of the wrong shape")
        log(f"clip_vit-b16 text tower: packed zero-shot weights vs quant mode max abs {err:.3e} "
            f"(unit vectors, <= 5e-2)")
        check(err <= 5e-2, "clip text tower: packed vs quant-mode agreement failed")
        # one recorded packed pass: every causal K8 call held against its
        # plain version as it is made; the other kernels at each signature
        with Recorder(compare_each=("mha_rows",)) as rec:
            model.precompute(toks, mode="packed")
        k8 = rec.errs["mha_rows"]
        check(len(k8) == CLIP_TEXT_PER_PASS["mha_rows"],
              f"clip text tower: {len(k8)} K8 calls compared, expected 12")
        (k8_args, _), = rec.calls["mha_rows"].values()
        check(k8_args[3] is True and k8_args[2] == 80 and k8_args[5] == 77,
              f"clip text tower: K8 called with {describe('mha_rows', k8_args)} "
              f"causal={k8_args[3]}")
        max_err["mha_rows"] = max(k8)
        log(f"clip_vit-b16 text tower: all {len(k8)} causal K8 calls of one packed pass "
            f"({describe('mha_rows', k8_args)}) within rtol 1e-4 / atol 1e-5 of the plain "
            f"version, max abs err {max(k8):.3e}")
        names = tuple(n for n in CLIP_TEXT_PER_PASS if n != "mha_rows")
        n = check_kernels([rec.calls], names, max_err)
        log(f"clip_vit-b16 text tower kernels: {n} more kernel-vs-plain comparisons passed; max "
            f"abs err {max_err}")
        text_ms = cuda_ms(lambda: model.precompute(toks, mode="packed"), reps=3, warmup=1)
        fp32_ms = cuda_ms(lambda: model.precompute(toks, mode="fp32"), reps=3, warmup=1)
        log(f"time: clip_vit-b16 text tower packed pass over {n_prompts} prompts: {text_ms:.3f} ms "
            f"(fp32 pass {fp32_ms:.3f} ms) [{card}]")
        from scripts.profile_torch_port import profile_calls

        profile_calls(lambda: model.precompute(toks, mode="packed"),
                      f"clip_vit-b16 text tower packed pass, {n_prompts} prompts [{card}]", n_fwd=2)
        kernel_entries(rec.calls, counts, max_err, tuple(CLIP_TEXT_PER_PASS), "clip text tower")
    del model, requests, rec, quant_emb, packed_emb
    torch.cuda.empty_cache()


def clip_rn_phase(qtt, batch, card, dev) -> None:
    """CLIP RN50 W8A8's image tower (module docstring, phase 5b)."""
    import torch

    t0 = time.time()
    model = qtt.MODELS.build("clip_rn50", num_classes=CLIP_CLASSES, ctx=qtt.QuantCtx(CFG))
    sample = batch(32)
    qtt.init_model(model, sample, seed=0)
    qtt.calibrate_model(model, [batch(32) for _ in range(4)])
    model.precompute(clip_tokens(), mode="fp32")
    qtt.pack_model(model, sample)
    torch.cuda.synchronize()
    log(f"clip_rn50 W8A8 set-up (init, calibrate 4x32, fp32 zero-shot weights, pack) "
        f"{time.time() - t0:.1f} s")
    requests = [batch(128) for _ in range(4)]
    with torch.inference_mode():
        outs, counts = serve(model, requests, CLIP_RN_PER_FWD, "clip_rn50", classes=CLIP_CLASSES)
        check_routes("w8a8_gemm", counts["w8a8_gemm"], "clip_rn50")
        x0, packed = requests[0], outs[0]
        sim = model(x0, mode="quant")
        # the CNN gate on the tower's output: with random weights the
        # zero-shot logits are exp(logit_scale) times cosines of nearly
        # orthogonal embeddings, so max|logits| is small and the logits'
        # relative reading magnifies the same feature error (printed beside)
        r_emb = rel(model.clip.encode_image(x0, mode="packed"),
                    model.clip.encode_image(x0, mode="quant"))
        r_sim = rel(packed, sim)
        same = float((packed.argmax(-1) == sim.argmax(-1)).float().mean())
        log(f"clip_rn50 agreement: image features packed vs quant-sim {r_emb:.3e} of max|feature| "
            f"(<= 2e-2); zero-shot logits {r_sim:.3e} of max|logits| "
            f"({float(sim.abs().max()):.4f}); argmax agreement {same:.4f}")
        check(r_emb <= 2e-2, "clip_rn50 agreement failed")
        del sim
        # every kernel call of one recorded forward, and the attention
        # pool's input for its mean token
        pool_in = []
        hook = model.clip.visual.attnpool.register_forward_pre_hook(
            lambda mod, args: pool_in.append(args[0]))
        with Recorder(every=tuple(CLIP_RN_PER_FWD)) as rec:
            model(requests[1], mode="packed")
        hook.remove()
        max_err = {}
        n = check_kernels([rec.calls], tuple(CLIP_RN_PER_FWD), max_err)
        log(f"clip_rn50 kernels: {n} kernel-vs-plain comparisons passed (every call of one "
            f"forward, bit-equal); max abs err {max_err}")
        x = pool_in[0]
        seq = x.reshape(x.shape[0], -1, x.shape[-1]).float()
        count = torch.tensor(float(seq.shape[1]), dtype=torch.float32)
        card_mean = seq.sum(dim=1) / count.to(dev)
        cpu_mean = seq.cpu().sum(dim=1) / count
        scale = float(cpu_mean.abs().max())
        r_div = float((card_mean.cpu() - cpu_mean).abs().max()) / scale
        r_mean = float((seq.mean(dim=1).cpu() - seq.cpu().mean(dim=1)).abs().max()) / scale
        log(f"clip_rn50 attention pool mean token over {seq.shape[1]} positions, card vs CPU: "
            f"sum / float32 count {r_div:.3e}, Tensor.mean {r_mean:.3e} of max|token|")
        times = {}
        for label, carry in (("packed f32 carry", torch.float32),
                             ("packed bf16 carry", torch.bfloat16)):
            with qtt.packed_carry(carry):
                times[label] = cuda_ms(lambda: model(requests[2], mode="packed"))
        times["fp32 forward (yardstick)"] = cuda_ms(lambda: model(requests[2], mode="fp32"))
        for label, ms in times.items():
            log(f"time: clip_rn50 image tower {label}: {ms:.3f} ms per batch of 128, "
                f"{128e3 / ms:.1f} img/s [{card}]")
        where_it_goes(model, requests[2], f"clip_rn50 image tower packed, batch 128, f32 carry "
                      f"[{card}]")
        kernel_entries({k: by_signature(v) for k, v in rec.calls.items()}, counts, max_err,
                       tuple(CLIP_RN_PER_FWD), "clip_rn50")
    del model, requests, outs, rec, pool_in
    torch.cuda.empty_cache()


def long_attention_phase(qtt, card, dev) -> None:
    """ViT-B/16 W4A8 at 384 x 384 (phase 6), and K8 / K9 at the long
    shapes the dispatch sends them."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(384)

    def batch(n):
        return torch.randn((n, 384, 384, 3), generator=gen, device=dev)

    t0 = time.time()
    model = qtt.MODELS.build("vit_b_16", num_classes=1000, ctx=qtt.QuantCtx(CFG_W4A8),
                             image_size=384)
    sample = batch(8)
    qtt.init_model(model, sample, seed=0)
    qtt.calibrate_model(model, [batch(8) for _ in range(4)])
    qtt.pack_model(model, sample)
    torch.cuda.synchronize()
    log(f"vit_b_16@384 W4A8 set-up (init, calibrate 4x8, pack) {time.time() - t0:.1f} s")
    request = batch(32)
    max_err = {}
    with torch.inference_mode():
        with qtt.packed_carry(torch.bfloat16):
            (out,), counts = serve(model, [request], VIT_PER_FWD, "vit_b_16@384 bf16 carry")
        for name in ("w4a8_gemm", "layernorm_quant_int8"):
            check_routes(name, counts[name], "vit_b_16@384 bf16 carry")
        with Recorder() as rec_f32:
            f32 = model(request, mode="packed")
        r_f32 = rel(out, f32)
        log(f"vit_b_16@384 agreement: bf16 carry vs f32 {r_f32:.3e} (<= 5e-2)")
        check(r_f32 <= 5e-2, "vit_b_16@384 agreement failed")
        # one recorded forward (K8's 12 calls), then timed without the recorders
        with qtt.packed_carry(torch.bfloat16), Recorder() as rec:
            model(request, mode="packed")
        with qtt.packed_carry(torch.bfloat16):
            ms = cuda_ms(lambda: model(request, mode="packed"))
        log(f"time: vit_b_16@384 packed bf16 carry: {ms:.3f} ms per batch of 32, "
            f"{32e3 / ms:.1f} img/s [{card}]")
        k8_calls = sum(c for _, c in rec.calls["mha_rows"].values())
        check(k8_calls == VIT_PER_FWD["mha_rows"],
              f"vit_b_16@384: the recorded forward made {k8_calls} K8 calls, expected "
              f"{VIT_PER_FWD['mha_rows']}")
        calls = {"mha_rows": rec.calls["mha_rows"], "mha_rows_int8": rec.calls["mha_rows"]}
        n = check_kernels([calls], ("mha_rows", "mha_rows_int8"), max_err)
        # K4 and K7 at the 384 shapes, both carries
        n += check_kernels([rec.calls, rec_f32.calls], ("w4a8_gemm", "layernorm_quant_int8"),
                           max_err)
        kernel_entries(calls, counts, max_err, ("mha_rows",), "vit_b_16@384")
    del model, request, out, f32, rec, rec_f32, calls
    torch.cuda.empty_cache()

    rows = torch.Generator(device=dev).manual_seed(776)
    from quantize_tpu_torch.ops import attention

    attention.mha_rows_int8.absmax_launches = 0
    for name, s, valid, dtype, e, heads in LONG_SHAPES:
        dtype = getattr(torch, dtype)
        qkv = (torch.randn((4 * s, 3 * e), generator=rows, device=dev) * 2).to(dtype)
        args = (qkv, heads, s, False, dtype, valid)
        check(attention.kernel_takes(qkv, heads, s, False, valid),
              f"{name} at S = {s}, E {e}, {heads} heads: the dispatch does not take it")
        max_err[name] = max(max_err.get(name, 0.0), compare(name, args))
        if name == "mha_rows_int8":
            check(bool(torch.equal(kernel_fn(name)(*args), plain_fn(name)(*args))),
                  f"{name} at S = {s}: not bit-equal to its plain version")
        if e == 512:  # the repaired head dim: times beside the bound, plain and library
            kernel_entries({name: {_sig(args): [args, 1]}}, {name: 0}, max_err, (name,),
                           "head dim 128")
        n += 1
    log(f"long attention shapes: {n} kernel-vs-plain comparisons passed; max abs err {max_err}; "
        f"K9's absmax pre-pass launched {attention.mha_rows_int8.absmax_launches} times "
        f"(streamed layout)")
    torch.cuda.empty_cache()


def w4a8_phase(dev) -> int:
    """K4 on random operands at the shapes no model of the phases above
    gives it (``W4A8_SHAPES``), each on the route its shape selects, bit for
    bit against the plain version."""
    import torch
    from quantize_tpu_torch.ops.qmatmul import pack_int4_splithalf, w4a8_gemm, w4a8_gemm_plain

    gen = torch.Generator(device=dev).manual_seed(4)
    for m, k, n, wz0, route in W4A8_SHAPES:
        q = torch.randint(-128, 128, (m, k), generator=gen, device=dev, dtype=torch.int8)
        w = torch.randint(-8, 8, (k, n), generator=gen, device=dev, dtype=torch.int8)
        w_zero = torch.zeros(n, device=dev) if wz0 else torch.randn(n, generator=gen, device=dev)
        args = (q, torch.tensor(131.5, device=dev), torch.tensor(0.02, device=dev),
                pack_int4_splithalf(w), w.sum(0, dtype=torch.int32),
                torch.rand(n, generator=gen, device=dev) * 0.01, w_zero,
                torch.randn(n, generator=gen, device=dev), wz0)
        for r in w4a8_gemm.route_launches:
            w4a8_gemm.route_launches[r] = 0
        got = w4a8_gemm(*args)
        want = w4a8_gemm_plain(*args)
        torch.cuda.synchronize()
        took = [r for r, c in w4a8_gemm.route_launches.items() if c]
        equal = bool(torch.equal(got, want))
        log(f"  w4a8_gemm M={m} K={k} N={n} z_w {'= 0' if wz0 else '!= 0'}: route {took}, "
            f"bit-equal {equal}, max abs err {float((got - want).abs().max()):.3e}")
        check(took == [route], f"w4a8_gemm at M={m} K={k} N={n}: route {took}, expected {route}")
        check(equal, f"w4a8_gemm at M={m} K={k} N={n}: not bit-equal to its plain version")
    return len(W4A8_SHAPES)


def w8a8_phase(dev, card) -> int:
    """K1 on random operands at the shapes of ``W8A8_SHAPES``, each on the
    route its shape selects, bit for bit against the plain version; its
    time beside its bound, the plain version's and the library call's."""
    import torch
    from quantize_tpu_torch.ops.qmatmul import _w8a8_split, kmajor_packed, w8a8_gemm

    gen = torch.Generator(device=dev).manual_seed(8)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for m, k, n, wz0, route in W8A8_SHAPES:
        q = torch.randint(-128, 128, (m, k), generator=gen, device=dev, dtype=torch.int8)
        w = torch.randint(-127, 128, (k, n), generator=gen, device=dev, dtype=torch.int8)
        w_zero = torch.zeros(n, device=dev) if wz0 else torch.randn(n, generator=gen, device=dev)
        args = (q, torch.tensor(131.5, device=dev), torch.tensor(0.0123, device=dev), w,
                w.sum(0, dtype=torch.int32), torch.rand(n, generator=gen, device=dev) * 0.01,
                w_zero, torch.randn(n, generator=gen, device=dev), wz0, kmajor_packed(w))
        for r in w8a8_gemm.route_launches:
            w8a8_gemm.route_launches[r] = 0
        compare("w8a8_gemm", args)
        took = [r for r, c in w8a8_gemm.route_launches.items() if c]
        check(took == [route], f"w8a8_gemm at M={m} K={k} N={n}: route {took}, expected {route}")
        ops, peak, nbytes = work("w8a8_gemm", args)
        b_ms, b_by = bound_ms(ops, peak, nbytes)
        k_ms = cuda_ms(lambda: w8a8_gemm(*args), reps=5, inner=10)
        p_ms = cuda_ms(lambda: plain_fn("w8a8_gemm")(*args), reps=3, warmup=1)
        lib = library_call("w8a8_gemm", args)
        l_ms = cuda_ms(lib, reps=5, inner=5) if lib is not None else None
        split = _w8a8_split(m, n, k, sms) if route == "wgmma" else 1
        log(f"kernel w8a8_gemm M={m} K={k} N={n} z_w {'= 0' if wz0 else '!= 0'}: route {took} "
            f"(cluster of {split}), bit-equal, {k_ms:.4f} ms (bound {b_ms:.4f} ms by {b_by}, "
            f"{b_ms / k_ms:.1%} of it), plain {p_ms:.3f} ms, "
            f"library {'n/a' if l_ms is None else f'{l_ms:.4f} ms'} [{card}]")
    return len(W8A8_SHAPES)


def conv1x1_phase(dev) -> int:
    """K2 on random operands at the shapes no model of the phases above
    gives it (``CONV1X1_SHAPES``), each on the route its shape selects, bit
    for bit against the plain version; the per-launch time of each."""
    import torch
    from quantize_tpu_torch.ops.qconv1x1 import conv1x1_residual_gemm, conv1x1_residual_plain

    gen = torch.Generator(device=dev).manual_seed(2)
    for m, k, n, res_dt, out_dt, relu, with_bias, route in CONV1X1_SHAPES:
        q = torch.randint(-128, 128, (m, k), generator=gen, device=dev, dtype=torch.int8)
        w = torch.randint(-127, 128, (k, n), generator=gen, device=dev, dtype=torch.int8)
        res = (torch.randn((m, n), generator=gen, device=dev) * 4).to(getattr(torch, res_dt))
        args = (q, torch.tensor(131.5, device=dev), torch.tensor(0.0123, device=dev), w,
                w.sum(0, dtype=torch.int32), torch.rand(n, generator=gen, device=dev) * 0.01,
                torch.randn(n, generator=gen, device=dev) if with_bias else None, res, relu,
                getattr(torch, out_dt), w.t().contiguous())
        for r in conv1x1_residual_gemm.route_launches:
            conv1x1_residual_gemm.route_launches[r] = 0
        got = conv1x1_residual_gemm(*args)
        want = conv1x1_residual_plain(*args)
        torch.cuda.synchronize()
        took = [r for r, c in conv1x1_residual_gemm.route_launches.items() if c]
        equal = bool(torch.equal(got, want))
        ms = cuda_ms(lambda: conv1x1_residual_gemm(*args), reps=3, inner=5)
        log(f"  conv1x1_residual M={m} K={k} N={n} {res_dt} -> {out_dt} relu={relu} "
            f"bias={with_bias}: route {took}, bit-equal {equal}, max abs err "
            f"{float((got.float() - want.float()).abs().max()):.3e}, {ms:.4f} ms")
        check(took == [route], f"conv1x1_residual at M={m} K={k} N={n}: route {took}, "
              f"expected {route}")
        check(equal, f"conv1x1_residual at M={m} K={k} N={n}: not bit-equal to its plain version")
    return len(CONV1X1_SHAPES)


# -- phase 7: training ---------------------------------------------------------------

class ArrayLoader:
    """Batches of numpy arrays: what a runner reads of a loader (iteration,
    ``len`` and ``batch_size``)."""

    def __init__(self, batches):
        self.batches, self.batch_size = batches, len(batches[0]["label"])

    def __iter__(self):
        return iter(self.batches)

    def __len__(self):
        return len(self.batches)


def train_config(path: str, out_dir, train: dict, **runner):
    """The model, quant, runner, optimizer and lr_scheduler sections of the
    config at ``path`` (its ``_base_`` chain resolved; the dataset sections
    left out), ``train`` as the train section and ``runner`` over its
    runner section."""
    from quantize_tpu_torch.utils import Config

    src = Config()
    src.merge_from_yaml(path)
    return Config({"seed": 0, "output_dir": str(out_dir), "model": src.model.to_dict(),
                   "runner": {**src.runner.to_dict(), **runner}, "quant": src.quant.to_dict(),
                   "optimizer": src.optimizer.to_dict(),
                   "lr_scheduler": src.lr_scheduler.to_dict(),
                   "train": {"print_freq": 1000, **train}})


def nonzero_leaves(grads: dict) -> set:
    """The leaves whose gradient's largest entry exceeds 1e-6 of the largest
    entry of its collection's gradients."""
    top = {}
    for k, g in grads.items():
        col = k.split("/", 1)[0]
        top[col] = max(top.get(col, 0.0), 0.0 if g is None else float(g.abs().max()))
    return {k for k, g in grads.items()
            if g is not None and float(g.abs().max()) > 1e-6 * top[k.split("/", 1)[0]]}


def fp32_loss_and_grads(model, img, label):
    """The QAT loss of an fp32-mode forward, its logits and the ``params``
    gradients."""
    import torch
    from quantize_tpu_torch.nn.variables import trainable
    from quantize_tpu_torch.runners.base import masked_cross_entropy

    leaves = trainable(model, ("params",))
    logits = model(img, mode="fp32")
    loss = masked_cross_entropy(logits, label)
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return loss.detach(), logits.detach(), dict(zip(leaves, grads))


def qat_phase(qtt, card, dev) -> None:
    """ViT-B/16 W4A8 QAT on the card, then served packed (module docstring,
    phase 7a)."""
    import copy
    import tempfile

    import torch
    import quantize_tpu_torch.runners as runners
    from quantize_tpu_torch.nn.variables import trainable
    from quantize_tpu_torch.runners.qat import TRAINABLE, loss_and_grads
    from quantize_tpu_torch.utils import Logger

    gen = torch.Generator(device=dev).manual_seed(7)

    def batch(n):
        return {"img": torch.randn((n, TRAIN_IMAGE, TRAIN_IMAGE, 3), generator=gen, device=dev),
                "label": torch.randint(0, 1000, (n,), generator=gen, device=dev)}

    with tempfile.TemporaryDirectory() as out_dir:
        Logger(out_dir)  # the runner logs there, as the CLI sets it up
        t0 = time.time()
        cfg = train_config(QAT_CFG, out_dir, {"calibrated_epoch": 1, "max_epoch": 1})
        runner = runners.build_runner(cfg, device=dev)
        check(isinstance(runner, runners.QAT) and cfg.model.name == "vit_b_16"
              and cfg.optimizer.name == "adam", f"qat: {QAT_CFG} built {type(runner).__name__}")
        calib = [batch(QAT_BATCH) for _ in range(2)]
        runner.init_variables(calib[0])
        for i, b in enumerate(calib):
            runner.train_step(b, 0, i, len(calib))
        runner.update(0)  # the calibrated_epoch switch builds the optimizer
        check(runner.initialized, "qat: the calibrated_epoch switch did not happen")
        torch.cuda.synchronize()
        log(f"qat vit_b_16 W4A8 ({QAT_CFG}'s model and quant sections, Adam lr "
            f"{cfg.optimizer.lr}): set-up (init, 2 calibration steps of {QAT_BATCH}, the switch) "
            f"{time.time() - t0:.1f} s")

        # one step on 2 images from the same variables, on the card and on a
        # copy of the model on the CPU. In fp32 mode only the float32
        # arithmetic differs; in quant mode an ulp of it can move an
        # activation across a rounding boundary of the 8-bit grid, and the
        # W4A8 network carries each such step on, so the CPU's own movement
        # under a 1e-6 relative perturbation of the input is printed beside
        small = batch(2)
        x_c, y_c = small["img"].cpu(), small["label"].cpu()
        cpu_model = copy.deepcopy(runner.model).to("cpu")
        keys = set(trainable(runner.model, TRAINABLE))
        t0 = time.time()
        steps = {mode: (fn(runner.model, small["img"], small["label"]), fn(cpu_model, x_c, y_c))
                 for mode, fn in (("fp32", fp32_loss_and_grads), ("quant", loss_and_grads))}
        pert = torch.Generator().manual_seed(11)
        x_p = x_c * (1 + 1e-6 * torch.randn(x_c.shape, generator=pert))
        spread = loss_and_grads(cpu_model, x_p, y_c)
        cpu_s = time.time() - t0
        (loss_g, _, grads_g), (loss_c, _, grads_c) = steps["quant"]
        check(set(grads_g) == set(grads_c) == keys and len(keys) > 0,
              "qat: the trainable leaves differ between the card and the CPU")
        for key, g in grads_g.items():
            check(g is not None and bool(torch.isfinite(g).all()),
                  f"qat: {key} got no finite gradient")
        # nonzero: above 1e-6 of its collection's largest entry (a symmetric
        # quantizer's zero point gets float32 noise, two equal sums' difference)
        nonzero_g, nonzero_c = nonzero_leaves(grads_g), nonzero_leaves(grads_c)
        check(nonzero_g == nonzero_c, f"qat: leaves with a nonzero gradient differ: "
              f"{sorted(nonzero_g ^ nonzero_c)[:5]}")
        log(f"qat vit_b_16: one step on 2 images, card vs CPU: {len(keys)} trainable leaves, "
            f"{len(nonzero_g)} with a nonzero gradient on both, all finite (the CPU's three "
            f"steps {cpu_s:.1f} s)")
        for mode, limits in (("fp32", (1e-4, 1e-2)), ("quant", (1e-2, 1e-1))):
            (loss_g, _, grads_g), (loss_c, _, grads_c) = steps[mode]
            r_loss = abs(float(loss_g) - float(loss_c)) / abs(float(loss_c))
            line = (f"qat vit_b_16: {mode} mode, card vs CPU: loss {float(loss_g):.6f} vs "
                    f"{float(loss_c):.6f} ({r_loss:.2e} relative, <= {limits[0]:g}")
            if mode == "quant":
                line += (f"; the CPU's own under a 1e-6 perturbation of the input "
                         f"{abs(float(spread[0]) - float(loss_c)) / abs(float(loss_c)):.2e}")
            log(line + ")")
            check(r_loss <= limits[0], f"qat: the {mode}-mode loss on the card disagrees")
            for col in TRAINABLE if mode == "quant" else ("params",):
                ks = sorted(k for k in keys if k.startswith(col + "/"))
                c = torch.cat([grads_c[k].reshape(-1) for k in ks])
                r = float((torch.cat([grads_g[k].cpu().reshape(-1) for k in ks]) - c).norm()
                          / c.norm())
                line = (f"qat vit_b_16: {mode} mode, {col} gradient ({len(ks)} leaves) "
                        f"|card - CPU| / |CPU| {r:.3e} (<= {limits[1]:g}")
                if mode == "quant":
                    p = torch.cat([spread[2][k].reshape(-1) for k in ks])
                    line += f"; the CPU's own {float((p - c).norm() / c.norm()):.3e}"
                log(line + ")")
                check(r <= limits[1], f"qat: the {mode}-mode {col} gradient on the card disagrees")
        del cpu_model, steps, spread, grads_g, grads_c

        # 3 QAT steps of 64
        torch.cuda.reset_peak_memory_stats(dev)
        ms, losses = [], []
        for i, b in enumerate([batch(QAT_BATCH) for _ in range(3)]):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            loss, _, _ = runner.train_step(b, 1, i, 3)
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
            losses.append(loss)
        check(all(math.isfinite(x) for x in losses), f"qat: losses {losses}")
        peak = torch.cuda.max_memory_allocated(dev)
        log(f"time: qat vit_b_16 W4A8 train step, batch {QAT_BATCH} (quant-mode forward, backward, Adam "
            f"over {len(keys)} leaves): median {statistics.median(ms[1:]):.1f} ms of steps 2-3 "
            f"(steps {', '.join(f'{x:.1f}' for x in ms)} ms); losses "
            f"{', '.join(f'{x:.4f}' for x in losses)}; peak memory allocated "
            f"{peak / 2**30:.2f} GiB [{card}]")
        from scripts.profile_torch_port import profile_calls

        b = batch(QAT_BATCH)
        profile_calls(lambda: runner.train_step(b, 1, 0, 3),
                      f"qat vit_b_16 W4A8 train step, batch {QAT_BATCH} [{card}]", n_fwd=2)

        # the trained model packed and served
        model = runner.model
        t0 = time.time()
        qtt.pack_model(model, calib[0]["img"], device=dev)
        torch.cuda.synchronize()
        log(f"qat vit_b_16: pack {time.time() - t0:.1f} s")
        requests = [batch(TRAIN_REQUEST)["img"] for _ in range(4)]
        with torch.inference_mode():
            outs, _ = serve(model, requests, VIT_PER_FWD, "qat vit_b_16 (trained)")
            r_sim = rel(outs[0], model(requests[0], mode="quant"))
        log(f"qat vit_b_16: packed vs the trained model's quant mode {r_sim:.3e} of max|logits| "
            f"(<= 5e-2)")
        check(r_sim <= 5e-2, "qat: the packed trained model disagrees with its quant mode")
    del runner, model, requests, outs, calib
    torch.cuda.empty_cache()


def adaround_phase(qtt, card, dev) -> None:
    """MobileNetV2 W4 weight-only AdaRound, blockwise, at full width, then
    served packed (module docstring, phase 7b)."""
    import tempfile

    import numpy as np
    import torch
    import quantize_tpu_torch.runners as runners
    from quantize_tpu_torch.nn.variables import trainable
    from quantize_tpu_torch.ops.qmatmul import unpack_int4_splithalf
    from quantize_tpu_torch.quant.adaround import rect_sigmoid
    from quantize_tpu_torch.quant.pack import unpack_int4_pairs
    from quantize_tpu_torch.utils import Logger

    rng = np.random.default_rng(8)
    batches = [{"img": rng.standard_normal((ADA_BATCH, TRAIN_IMAGE, TRAIN_IMAGE, 3),
                                           dtype=np.float32),
                "label": rng.integers(0, 1000, ADA_BATCH).astype(np.int32)} for _ in range(2)]
    with tempfile.TemporaryDirectory() as out_dir:
        Logger(out_dir)
        cfg = train_config(ADAROUND_CFG, out_dir, {"max_epoch": 2}, reconstruction="blockwise")
        runner = runners.build_runner(cfg, ArrayLoader(batches), device=dev)
        check(isinstance(runner, runners.AdaRound) and cfg.model.name == "mobilenet_v2"
              and cfg.runner.beta == "dynamic", f"adaround: {ADAROUND_CFG} built "
              f"{type(runner).__name__}")
        v_init, layer_s = {}, []
        init, reconstruct = runner._init_adaround, runner.reconstruct_layer

        def init_and_keep(img):
            init(img)
            v_init.update({k: v.detach().clone()
                           for k, v in trainable(runner.model, ("adaround",)).items()})

        def timed(*args):
            torch.cuda.synchronize()
            t = time.time()
            loss = reconstruct(*args)
            layer_s.append(time.time() - t)
            return loss

        runner._init_adaround, runner.reconstruct_layer = init_and_keep, timed
        t0 = time.time()
        runner.run()
        torch.cuda.synchronize()
        total = time.time() - t0
        model = runner.model
        layers = runner.ada_layers()
        losses = runner.layer_losses
        check(len(losses) == len(layers) == MOBILENET_ADA_LAYERS
              and set(losses) == set(layers),
              f"adaround: {len(losses)} layers reconstructed of {len(layers)}, expected "
              f"{MOBILENET_ADA_LAYERS}")
        check(all(math.isfinite(x) for x in losses.values()), "adaround: a final loss is not finite")
        steps = cfg.train.max_epoch * len(batches)
        log(f"adaround mobilenet_v2 W4 ({ADAROUND_CFG}'s model and quant sections, Adam lr "
            f"{cfg.optimizer.lr}, beta dynamic), blockwise: {len(losses)} layers x {steps} steps "
            f"over {len(batches)} cached batches of {ADA_BATCH}; final losses "
            f"{min(losses.values()):.4g}-{max(losses.values()):.4g}")
        log(f"time: adaround mobilenet_v2 blockwise: {sum(layer_s) / (len(losses) * steps) * 1e3:.2f} "
            f"ms a layer-step ({sum(layer_s):.2f} s over {len(losses) * steps} layer-steps), "
            f"{total:.1f} s in all (calibration, capture to the host, reconstruction) [{card}]")

        init_err, moved = 0.0, 0
        torch.set_grad_enabled(False)
        for path, layer in layers.items():
            w = layer.get_var("params", "kernel")
            q = layer.w_quantizer
            v_over = w / q.get_var("qparams", "scale") - q.get_var("qparams", "zero")
            frac = (v_over - torch.floor(v_over)).clamp(-0.1 + 1e-6, 1.1 - 1e-6)
            v0 = v_init[f"adaround/{path}/w_quantizer/V"]
            init_err = max(init_err, float((rect_sigmoid(v0) - frac).abs().max()))
            moved += not torch.equal(q.get_var("adaround", "V"), v0)
        log(f"adaround: h(V_init) vs the fractional part of w / s - z: max abs {init_err:.2e} "
            f"(<= 1e-5); {moved} of {len(layers)} V moved")
        check(init_err <= 1e-5, "adaround: h(V_init) is not the fractional part")
        check(moved == len(layers), "adaround: a V did not move")

        sample = torch.from_numpy(batches[0]["img"]).to(dev)
        qtt.pack_model(model, sample, device=dev)
        n_ints = 0
        for path, layer in layers.items():
            q = layer.w_quantizer
            w = layer.get_var("params", "kernel")
            v_over = w / q.get_var("qparams", "scale") - q.get_var("qparams", "zero")
            want = torch.clamp(torch.round(torch.floor(v_over)
                                           + rect_sigmoid(q.get_var("adaround", "V"))),
                               q.spec.qmin, q.spec.qmax)
            if layer.has_var("packed", "w_p4c"):
                got = unpack_int4_pairs(layer.get_var("packed", "w_p4c"), axis=2)
            elif layer.has_var("packed", "w_p4"):
                got = unpack_int4_splithalf(layer.get_var("packed", "w_p4"))
            else:
                got = layer.get_var("packed", "w_int")
            check(bool(torch.equal(got.float(), want)),
                  f"adaround: {path}: the packed ints are not the AdaRound rounding")
            n_ints += want.numel()
        log(f"adaround: the packed ints of all {len(layers)} layers ({n_ints} weights) equal "
            f"round(floor(w / s - z) + h(V)) bit for bit")

        gen = torch.Generator(device=dev).manual_seed(9)
        requests = [torch.randn((TRAIN_REQUEST, TRAIN_IMAGE, TRAIN_IMAGE, 3), generator=gen,
                                device=dev) for _ in range(4)]
        with torch.inference_mode():
            outs, _ = serve(model, requests, MOBILENET_WO_PER_FWD, "adaround mobilenet_v2 (trained)")
            r_sim = rel(outs[0], model(requests[0], mode="quant"))
            with Recorder() as rec:
                model(requests[1], mode="packed")
        max_err = {}
        n = check_kernels([rec.calls], tuple(MOBILENET_WO_PER_FWD), max_err)
        log(f"adaround: packed vs the trained model's quant mode {r_sim:.3e} of max|logits| "
            f"(<= 2e-2); {n} kernel-vs-plain comparisons passed (K5 within its limit), max abs "
            f"err {max_err}")
        check(r_sim <= 2e-2, "adaround: the packed trained model disagrees with its quant mode")
        torch.set_grad_enabled(True)
    del runner, model, requests, outs, rec
    torch.cuda.empty_cache()


def train_cli_phase(card, dev) -> None:
    """TestCNN through the CLI with QAT and with AdaRound, joint and
    sequential (module docstring, phase 7c)."""
    import re
    import tempfile
    from pathlib import Path

    import torch
    from quantize_tpu_torch import cli

    for label, base, opts in TRAIN_CLI_RUNS:
        with tempfile.TemporaryDirectory() as out_dir:
            argv = ["--cfg", RUNNER_CFG, base, "--output-dir", out_dir, "--device", str(dev),
                    "--opts", "model.name=testcnn", "train_loader.batch_size=64",
                    "train.max_epoch=1", *opts]
            t0 = time.time()
            cli.main(argv)
            torch.cuda.synchronize()
            wall = time.time() - t0
            out = Path(out_dir)
            found = re.findall(r"test result: \{'top1': ([-+.\deE]+|nan), 'n': (\d+)\}",
                               (out / "output.log").read_text())
            check(len(found) == 1, f"runner {label}: no test result in output.log")
            top1, n_test = float(found[0][0]), int(found[0][1])
            check(0.0 <= top1 <= 100.0 and n_test == 256,
                  f"runner {label}: test top-1 {top1} over {n_test} examples")
            ckpt = torch.load(out / "ckpt_last.pkl", weights_only=True)["variables"]
            check(("adaround" in ckpt) == label.startswith("adaround"),
                  f"runner {label}: the checkpoint's collections {sorted(ckpt)}")
            log(f"runner {label} (TestCNN through the CLI, {base}): config to test result "
                f"{wall:.2f} s, test top-1 {top1:.2f}% over {n_test} [{card}]")


# -- phase 8: the int8 carry, the fault-tolerant run, unpack and profiling ------------

def carry_gates(qtt, model, requests, per_fwd: dict, label: str, names, routes: dict) -> dict:
    """One served configuration under the int8 carry (the caller's carry
    dtype and fused-tail setting): the launches per forward (``serve``),
    each kernel of ``routes`` on its route there (``check_routes``),
    within JAX's 8e-2 of max|logits| of the same model's packed forward
    without the carry, the argmax agreement printed; every kernel call of
    one recorded forward held against its plain version as it is made; the
    forward timed with and without the carry. Returns the recorded calls,
    the counts, the max abs errors and the times."""
    import torch

    with qtt.qin_carry(True):
        outs, counts = serve(model, requests, per_fwd, label)
    for name, route in routes.items():
        check_routes(name, counts[name], label, route)
    ref = model(requests[0], mode="packed")
    r = rel(outs[0], ref)
    agree = float((outs[0].argmax(-1) == ref.argmax(-1)).float().mean())
    log(f"{label}: carry vs the packed forward without it {r:.3e} of max|logits| (<= 8e-2), "
        f"argmax agreement {agree:.4f}")
    check(r <= 8e-2, f"{label}: the carry moves the logits beyond 8e-2")
    with qtt.qin_carry(True), Recorder(compare_each=names) as rec:
        model(requests[1], mode="packed")
    torch.cuda.synchronize()
    max_err = {name: max(rec.errs[name], default=0.0) for name in names}
    n = sum(len(rec.errs[name]) for name in names)
    check(n == sum(per_fwd.get(name, 0) for name in names),
          f"{label}: {n} kernel calls compared, expected {sum(per_fwd.values())}")
    log(f"{label}: every kernel call of one forward ({n}) against its plain version passed; "
        f"max abs err {max_err}")
    with qtt.qin_carry(True):
        t_carry = cuda_ms(lambda: model(requests[2], mode="packed"))
    t_plain = cuda_ms(lambda: model(requests[2], mode="packed"))
    return {"calls": rec.calls, "counts": counts, "max_err": max_err,
            "ms": (t_carry, t_plain), "out": outs[0]}


def quant_ignores_carry(qtt, model, x, label: str) -> None:
    import torch

    sim = model(x, mode="quant")
    with qtt.qin_carry(True):
        sim_carry = model(x, mode="quant")
    check(bool(torch.equal(sim, sim_carry)), f"{label}: quant mode reads the carry flag")
    log(f"{label}: quant mode bit-equal with the carry flag on and off")


def carry_resnet_phase(qtt, batch, card) -> tuple:
    """ResNet-50 W8A8 at 256 under the int8 carry (module docstring, phase
    8a); returns the model and its deploy variables for phase 8d."""
    import torch

    t0 = time.time()
    model = qtt.MODELS.build("resnet50", num_classes=1000, ctx=qtt.QuantCtx(CFG))
    sample = batch(32)
    qtt.init_model(model, sample, seed=0)
    qtt.calibrate_model(model, [batch(32) for _ in range(4)])
    deploy = qtt.pack_model(model, sample)
    torch.cuda.synchronize()
    log(f"carry resnet50 set-up (init, calibrate 4x32, pack) {time.time() - t0:.1f} s")
    requests = [batch(CARRY_BATCH) for _ in range(3)]
    measured = {}
    with torch.inference_mode():
        quant_ignores_carry(qtt, model, requests[0], "carry resnet50")
        for carry in (torch.float32, torch.bfloat16):
            for fused in (True, False):
                label = (f"carry resnet50 ({str(carry).replace('torch.', '')} carry, fused tail "
                         f"{'on' if fused else 'off'})")
                per_fwd = RESNET_PER_FWD if fused else RESNET_UNFUSED_PER_FWD
                routes = {"w8a8_gemm": "wgmma", **({"conv1x1_residual": "wgmma"} if fused else {})}
                with qtt.packed_carry(carry), qtt.fused_residual(fused):
                    res = carry_gates(qtt, model, requests, per_fwd, label, tuple(per_fwd), routes)
                t_carry, t_plain = res["ms"]
                measured[(carry, fused)] = t_carry
                log(f"time: {label}: {t_carry:.3f} ms per batch of {CARRY_BATCH} "
                    f"({CARRY_BATCH * 1e3 / t_carry:.1f} img/s), without the carry "
                    f"{t_plain:.3f} ms ({CARRY_BATCH * 1e3 / t_plain:.1f} img/s) [{card}]")
                if fused and carry == torch.bfloat16:
                    # K2 with the float32 residual of qin.dequant() and a bf16 output
                    kernel_entries(res["calls"], res["counts"], res["max_err"],
                                   ("conv1x1_residual",), "resnet50 bf16 carry under the carry")
        with qtt.fused_residual(True), qtt.qin_carry(True):
            where_it_goes(model, requests[2], f"resnet50 packed under the int8 carry, batch "
                          f"{CARRY_BATCH}, f32 carry, fused tail [{card}]")
    return model, deploy, requests[2], measured[(torch.float32, True)]


def carry_mobilenet_phase(qtt, batch, card) -> None:
    """MobileNetV3-Large W8A8 at 256 under the int8 carry (module
    docstring, phase 8b)."""
    import torch

    model = build_packed(qtt, batch, "mobilenet_v3_large", CFG_MOBILE, "mobilenet_v3_large W8A8")
    requests = [batch(CARRY_BATCH) for _ in range(3)]
    with torch.inference_mode():
        quant_ignores_carry(qtt, model, requests[0], "carry mobilenet_v3_large")
        outs, _ = serve(model, requests, MNV3_PER_FWD, "mobilenet_v3_large without the carry")
        for carry in (torch.float32, torch.bfloat16):
            label = f"carry mobilenet_v3_large ({str(carry).replace('torch.', '')} carry)"
            with qtt.packed_carry(carry):
                res = carry_gates(qtt, model, requests, MNV3_CARRY_PER_FWD, label,
                                  tuple(MNV3_CARRY_PER_FWD),
                                  {"qconv2d_grouped": "dp4a", "w8a8_gemm": "wgmma"})
            (args, n), = res["calls"]["qconv2d_grouped"].values()
            q, w, groups = args[0], args[3], args[12]
            side = requests[0].shape[1] // 2  # after the stride-2 stem
            check(tuple(q.shape) == (requests[0].shape[0], side, side, 16) and w.shape[2] == 1
                  and groups == 16 and n == 1,
                  f"{label}: K3g's call x{tuple(q.shape)} w{tuple(w.shape)} G={groups}")
            log(f"{label}: the first block's depthwise conv on K3g's dp4a route, "
                f"{describe('qconv2d_grouped', args)} (Ci/G = 1), bit-equal to its plain version")
            t_carry, t_plain = res["ms"]
            log(f"time: {label}: {t_carry:.3f} ms per batch of {CARRY_BATCH} "
                f"({CARRY_BATCH * 1e3 / t_carry:.1f} img/s), without the carry {t_plain:.3f} ms "
                f"({CARRY_BATCH * 1e3 / t_plain:.1f} img/s) [{card}]")
            if carry == torch.float32:
                kernel_entries(res["calls"], res["counts"], res["max_err"], ("qconv2d_grouped",),
                               "mobilenet_v3_large under the carry")
        t_fp32 = cuda_ms(lambda: model(requests[2], mode="fp32"))
        log(f"time: mobilenet_v3_large fp32 forward (yardstick): {t_fp32:.3f} ms per batch of "
            f"{CARRY_BATCH} [{card}]")
        n = requests[2].shape[0]
        where_it_goes(model, requests[2], f"mobilenet_v3_large packed, batch {n}, f32 carry "
                      f"[{card}]")
        with qtt.qin_carry(True):
            where_it_goes(model, requests[2], f"mobilenet_v3_large packed under the int8 carry, "
                          f"batch {n}, f32 carry [{card}]")
    del model, requests, outs
    torch.cuda.empty_cache()


def fault_phase(qtt, card, dev) -> None:
    """ViT-B/16 W4A8 QAT under ``supervised_run`` with an injected crash and
    an injected NaN loss (module docstring, phase 8c)."""
    import json as _json
    import os
    import tempfile

    import numpy as np
    import torch
    import quantize_tpu_torch.runners as runners
    from quantize_tpu_torch.parallel import FaultInjector, HealthMonitor, Heartbeat
    from quantize_tpu_torch.runners.resume import supervised_run
    from quantize_tpu_torch.utils import Logger

    rng = np.random.default_rng(12)
    batches = [{"img": rng.standard_normal((QAT_BATCH, TRAIN_IMAGE, TRAIN_IMAGE, 3),
                                           dtype=np.float32),
                "label": rng.integers(0, 1000, QAT_BATCH).astype(np.int32)} for _ in range(2)]
    for label, inject, monitor, error in FAULT_RUNS:
        with tempfile.TemporaryDirectory() as out_dir:
            Logger(out_dir)
            cfg = train_config(QAT_CFG, out_dir, {"calibrated_epoch": 1, "max_epoch": 2})
            losses, built = [], []

            def factory(attempt):
                runner = runners.build_runner(cfg, ArrayLoader(batches), device=dev)
                step = runner.train_step

                def recorded(*args):
                    out = step(*args)
                    losses.append(out[0])
                    return out

                runner.train_step = recorded
                built.append(runner)
                return runner

            hb = os.path.join(out_dir, "p0.heartbeat")
            t0 = time.time()
            result = supervised_run(factory, max_restarts=2, injector=FaultInjector(**inject),
                                    heartbeat=Heartbeat(hb),
                                    monitor_factory=lambda: HealthMonitor(**monitor))
            torch.cuda.synchronize()
            wall = time.time() - t0
            runner = result.runner
            state = _json.load(open(os.path.join(out_dir, "resume_state.json")))
            restarts = [(e.attempt, e.error) for e in result.restarts]
            log(f"fault {label}: vit_b_16 W4A8 QAT ({QAT_CFG}), {runner.max_epoch} epochs of "
                f"{len(batches)} steps of {QAT_BATCH} under supervised_run: restarts {restarts}, "
                f"resume state epoch {state.get('epoch')} finished {state.get('finished')}, "
                f"heartbeat step {Heartbeat.read(hb)['step']}, {len(built)} runners built, "
                f"{wall:.1f} s in all [{card}]")
            check(len(restarts) == 1 and error in restarts[0][1],
                  f"fault {label}: restarts {restarts}")
            check(bool(state.get("finished")) and state.get("epoch") == runner.max_epoch - 1,
                  f"fault {label}: resume state {state}")
            check(all(math.isfinite(x) for x in losses if x is not None),
                  f"fault {label}: losses {losses}")
            log(f"fault {label}: step losses {', '.join(f'{x:.4f}' for x in losses)} (the "
                f"resumed runner calibrates again: the QAT switch is not in the checkpoint, as "
                f"in JAX)")

            # the epoch checkpoint reloads bit-equal into a fresh runner
            ckpt = state["checkpoint"]
            size = os.path.getsize(ckpt)
            fresh = runners.build_runner(cfg, device=dev)
            torch.cuda.synchronize()
            t0 = time.time()
            fresh.load_checkpoint(ckpt)
            torch.cuda.synchronize()
            t_read = time.time() - t0
            mine, theirs = fresh.variables, runner.variables
            same = set(mine) == set(theirs) and all(
                set(mine[c]) == set(theirs[c]) and all(
                    mine[c][k].dtype == theirs[c][k].dtype and torch.equal(mine[c][k], theirs[c][k])
                    for k in theirs[c]) for c in theirs)
            check(same, f"fault {label}: the epoch checkpoint does not reload bit-equal")
            path = os.path.join(out_dir, "ckpt_write.pkl")
            torch.cuda.synchronize()
            t0 = time.time()
            runner.save_checkpoint(path)
            t_write = time.time() - t0
            n_leaves = sum(len(v) for v in theirs.values())
            log(f"time: fault {label}: the vit_b_16 checkpoint ({n_leaves} leaves, "
                f"{size / 2**20:.1f} MiB) written in {t_write:.3f} s, read into a fresh runner "
                f"in {t_read:.3f} s, every leaf bit-equal [{card}]")
            del fresh, mine

            # the trained model served packed
            model = runner.model
            gen = torch.Generator(device=dev).manual_seed(13)
            requests = [torch.randn((TRAIN_REQUEST, TRAIN_IMAGE, TRAIN_IMAGE, 3), generator=gen,
                                    device=dev) for _ in range(2)]
            qtt.pack_model(model, torch.from_numpy(batches[0]["img"]).to(dev), device=dev)
            with torch.inference_mode():
                outs, _ = serve(model, requests, VIT_PER_FWD, f"fault {label} vit_b_16 (trained)")
                r_sim = rel(outs[0], model(requests[0], mode="quant"))
            log(f"fault {label}: packed vs the model's quant mode {r_sim:.3e} of max|logits| "
                f"(<= 5e-2)")
            check(r_sim <= 5e-2, f"fault {label}: the packed model disagrees with its quant mode")
            del runner, result, built, model, requests, outs
            torch.cuda.empty_cache()


def unpack_profile_phase(qtt, model, deploy, x, measured_ms: float, card, dev) -> None:
    """``unpack_model`` on the card, and the profiler (module docstring,
    phase 8d)."""
    import os
    import tempfile

    import torch
    from quantize_tpu_torch import convert, profiling

    with torch.inference_mode():
        restored = qtt.unpack_model(deploy)
        fresh = qtt.MODELS.build("resnet50", num_classes=1000, ctx=qtt.QuantCtx(CFG))
        convert.from_jax_variables(fresh, restored)
        sim, sim_r, fp32_r = (model(x, mode="quant"), fresh(x, mode="quant"),
                              fresh(x, mode="fp32"))
        err = float(((sim_r - sim).abs() - 2e-3 * sim.abs()).max())
        log(f"unpack resnet50 W8A8: {len(restored['params'])} params leaves; the unpacked "
            f"model's quant mode vs the original's: max |diff| - 2e-3 |ref| {err:.3e} (<= 2e-3); "
            f"its fp32 forward (float activations) vs the original quant mode {rel(fp32_r, sim):.3e}"
            f" of max|logits|")
        check(err <= 2e-3, "unpack resnet50: the unpacked model's quant mode disagrees")
        del fresh, restored

        # JAX tests/test_packed.py's round trip at its own config: W8 weight-only
        wo = build_packed(qtt, lambda n: x[:n], "resnet50", CFG_W8_ONLY,
                          "resnet50 W8 weight-only")
        fresh = qtt.MODELS.build("resnet50", num_classes=1000, ctx=qtt.QuantCtx(CFG_W8_ONLY))
        convert.from_jax_variables(fresh, qtt.unpack_model(qtt.pack_model(wo, x[:32])))
        sim, fp32_r = wo(x, mode="quant"), fresh(x, mode="fp32")
        err = float(((fp32_r - sim).abs() - 2e-3 * sim.abs()).max())
        log(f"unpack resnet50 W8 weight-only: the unpacked model's fp32 forward vs the original "
            f"quant mode: max |diff| - 2e-3 |ref| {err:.3e} (<= 2e-3)")
        check(err <= 2e-3, "unpack resnet50 W8 weight-only: the round trip disagrees")
        del wo, fresh, sim, fp32_r

        with qtt.fused_residual(True):
            rep = profiling.roofline_report(lambda i: model(i, mode="packed"), x)
            log(f"roofline resnet50 W8A8 packed, batch {x.shape[0]}, f32 carry, fused tail (H100 SXM peaks): "
                f"{rep}; speed of light {rep['speed_of_light_ms']:.3f} ms beside the measured "
                f"{measured_ms:.3f} ms (phase 8a, under the carry) [{card}]")
            check(rep["n_ops"] == RESNET_PER_FWD["qconv2d"] + RESNET_PER_FWD["conv1x1_residual"]
                  + RESNET_PER_FWD["w8a8_gemm"], f"roofline: {rep['n_ops']} contractions counted")
            with tempfile.TemporaryDirectory() as d:
                t0 = time.time()
                with profiling.trace(d):
                    model(x, mode="packed")
                path = os.path.join(d, profiling.TRACE_FILE)
                check(os.path.exists(path) and os.path.getsize(path) > 0,
                      "profiling.trace wrote no trace")
                log(f"profiling.trace of a packed forward: {os.path.getsize(path) / 2**20:.2f} MiB "
                    f"written in {time.time() - t0:.1f} s")


# -- phase 9: the serving engine and real data ---------------------------------------

def normalizer(dev):
    """The on-card preprocess of the uint8 requests: ImageNet's normalize of
    x / 255, as ``(x - 255 mean) / (255 std)``, divided by a tensor."""
    import torch

    shift = torch.tensor([255.0 * m for m in IMAGENET_MEAN], device=dev)
    scale = torch.tensor([255.0 * s for s in IMAGENET_STD], device=dev)
    return lambda x: (x.float() - shift) / scale


def direct_rows(model, pre, requests, batch: int, dev, post=None, pool=None):
    """The direct packed forward ``post(model(pre(x)))`` over ``requests``
    (uint8 host images, or int32 indices into the card's ``pool``) in
    batches of ``batch``: numpy rows, float32 unless ``post`` says."""
    import numpy as np
    import torch

    out = []
    with torch.inference_mode():
        for lo in range(0, len(requests), batch):
            x = torch.from_numpy(np.ascontiguousarray(requests[lo:lo + batch])).to(dev)
            if pool is not None:
                x = pool.index_select(0, x.long())
            o = model(pre(x), mode="packed")
            out.append((post(o) if post is not None else o.float()).cpu().numpy())
    return np.concatenate(out)


def produce(eng, requests) -> list:
    """``requests`` sent to the engine by one thread a producer
    (``SERVE_PRODUCERS``), each through its call: ``[(lo, hi, future)]``, the future resolving to the result of
    row lo (``submit``, ``submit_many``) or the stacked rows lo..hi
    (``submit_batch``)."""
    import threading

    jobs, lo = [], 0
    for kind, n in SERVE_PRODUCERS:
        jobs.append((kind, lo, lo + n))
        lo += n
    check(lo == len(requests), f"the producers send {lo} of {len(requests)} requests")
    sent = [None] * len(jobs)

    def run(j, kind, lo, hi):
        if kind == "submit":
            sent[j] = [(i, i + 1, eng.submit(requests[i])) for i in range(lo, hi)]
        elif kind == "submit_many":
            sent[j] = [(lo + k, lo + k + 1, f)
                       for k, f in enumerate(eng.submit_many(requests[lo:hi]))]
        else:
            b = eng.batch_size
            sent[j] = [(lo + k * b, min(lo + (k + 1) * b, hi), f)
                       for k, f in enumerate(eng.submit_batch(requests[lo:hi]))]

    threads = [threading.Thread(target=run, args=(j, *job)) for j, job in enumerate(jobs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    check(all(not t.is_alive() for t in threads) and all(s is not None for s in sent),
          "a producer thread did not finish")
    return [x for s in sent for x in s]


def gather(futs, n: int, row_shape: tuple, dtype):
    """The results of every future, as rows in request order."""
    import numpy as np

    out = np.empty((n, *row_shape), dtype)
    for lo, hi, f in futs:
        out[lo:hi] = f.result(timeout=300)
    return out


def served_gates(eng, counts: dict, per_fwd: dict, label: str, routes=()) -> dict:
    """No failed request, and the launches per batch (padded batches
    included) and their routes."""
    st = eng.stats()
    log(f"{label}: {st['processed']} requests in {st['batches']} batches (mean fill "
        f"{st['mean_batch_fill']:.4f}, max in flight {st['max_observed_in_flight']}, host "
        f"staging {st['staging_ms']:.3f} ms and dispatch {st['dispatch_ms']:.3f} ms a batch), failed "
        f"{st['failed']}; launches {counts}")
    check(st["failed"] == 0, f"{label}: {st['failed']} requests failed")
    for name, n in per_fwd.items():
        check(counts[name] == n * st["batches"],
              f"{label}: {name}: {counts[name]} launches, expected {n} x {st['batches']} batches")
    for name, n in counts.items():
        check(name in per_fwd or n == 0, f"{label}: {name} launched {n} times, expected none")
    for name in routes:
        check_routes(name, counts[name], label)
    return st


def check_rows(got, want, label: str) -> None:
    """Every served row bit-equal to the direct forward's."""
    import numpy as np

    check(got.shape == want.shape, f"{label}: results {got.shape}, direct {want.shape}")
    differ = [i for i in range(len(got)) if not np.array_equal(got[i], want[i])]
    log(f"{label}: {len(got) - len(differ)} of {len(got)} results bit-equal to the direct "
        f"forward" + (f"; rows {differ[:8]} differ by up to "
                      f"{float(np.abs(got[differ].astype(np.float64) - want[differ]).max()):.3e}"
                      if differ else ""))
    check(not differ, f"{label}: {len(differ)} results differ from the direct forward")


def engine_rates(model, requests, label: str, card, batch: int, **kw) -> dict:
    """Engine img/s over ``requests`` sent by one ``submit_batch``, at each of
    ``SERVE_IN_FLIGHT``: the median of ``SERVE_REPS`` runs after one run
    left out (the pinned host buffers are allocated there); ``{in_flight:
    (img/s, stats of the last run)}``."""
    from quantize_tpu_torch.parallel import InferenceEngine

    out = {}
    for in_flight in SERVE_IN_FLIGHT:
        rates = []
        for _ in range(SERVE_REPS + 1):
            with InferenceEngine(model, batch_size=batch, max_in_flight=in_flight, **kw) as eng:
                t0 = time.perf_counter()
                for f in eng.submit_batch(requests):
                    f.result(timeout=300)
                rates.append(len(requests) / (time.perf_counter() - t0))
            check(eng.n_failed == 0, f"{label}: requests failed")
        stats = eng.stats()
        rate = statistics.median(rates[1:])
        out[in_flight] = (rate, stats)
        log(f"time: {label}, max_in_flight {in_flight}: {rate:.1f} img/s (runs "
            f"{', '.join(f'{r:.1f}' for r in rates[1:])}; mean fill {stats['mean_batch_fill']:.4f}, "
            f"max in flight {stats['max_observed_in_flight']}, host staging "
            f"{stats['staging_ms']:.3f} ms and dispatch {stats['dispatch_ms']:.3f} ms a batch) [{card}]")
    return out


def host_enqueue_ms(fn) -> float:
    """Host time to queue one call of ``fn`` with the card idle before it
    (median of 4; no backlog of launches in the way), after checking in
    torch's sync debug mode that the call never waits for the card."""
    import torch

    fn()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    except RuntimeError as exc:
        raise Failure(f"the call synchronizes the host with the card: {exc}") from exc
    finally:
        torch.cuda.set_sync_debug_mode(0)
    times = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def serving_phase(qtt, model, deploy, card, dev) -> None:
    """ResNet-50 W8A8 served through the engine (module docstring, phases
    9a-9c), from phase 8's packed model and its deploy variables."""
    import numpy as np
    import torch
    from quantize_tpu_torch.ops import launch_counts, reset_launch_counts
    from quantize_tpu_torch.parallel import InferenceEngine

    t0 = time.time()
    images = np.random.default_rng(9).integers(0, 256, (SERVE_IMAGES, SERVE_IMAGE, SERVE_IMAGE, 3),
                                               dtype=np.uint8)
    pre = normalizer(dev)
    log(f"serving: {SERVE_IMAGES} seeded uint8 requests of {SERVE_IMAGE} x {SERVE_IMAGE} x 3 made in "
        f"{time.time() - t0:.1f} s ({images[:SERVE_BATCH].nbytes / 1e6:.1f} MB a batch of "
        f"{SERVE_BATCH})")
    kw = dict(max_wait_ms=2.0, input_dtype=np.uint8, preprocess=pre, device=dev)
    served = {}
    for carry in (torch.bfloat16, torch.float32):
        name = str(carry).replace("torch.", "")
        label = f"engine resnet50 W8A8 ({name} carry, fused tail)"
        with qtt.packed_carry(carry), qtt.fused_residual(True):
            want = direct_rows(model, pre, images, SERVE_BATCH, dev)  # warms the model too
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            with InferenceEngine(model, batch_size=SERVE_BATCH, **kw) as eng:
                futs = produce(eng, images)
                got = gather(futs, len(images), (1000,), np.float32)
            wall = time.perf_counter() - t0
            torch.cuda.synchronize()
            counts = launch_counts()
            log(f"{label}: four producers ({', '.join(f'{n} by {k}' for k, n in SERVE_PRODUCERS)}) "
                f"served in {wall:.3f} s, {len(images) / wall:.1f} img/s [{card}]")
            served_gates(eng, counts, RESNET_PER_FWD, label, ("conv1x1_residual", "w8a8_gemm"))
            check_rows(got, want, label)
            served[name] = got
            if carry == torch.bfloat16:
                bad_request(model, images, want, kw, label)
                rates = engine_rates(model, images, label + " by submit_batch", card, SERVE_BATCH,
                                     **kw)
                x = torch.from_numpy(images[:SERVE_BATCH]).to(dev)
                with torch.inference_mode():
                    raw_ms = cuda_ms(lambda: model(pre(x), mode="packed"), reps=5, inner=4)
                    host_ms = host_enqueue_ms(lambda: model(pre(x), mode="packed"))
                log(f"resnet50 W8A8 packed forward (bf16 carry, fused tail): no host "
                    f"synchronization (torch's sync debug mode); the host queues a forward in "
                    f"{host_ms:.3f} ms (median of 4, Python and the wrappers' launches) beside "
                    f"{raw_ms:.3f} ms back to back on the card [{card}]")
                pinned = torch.from_numpy(images[:SERVE_BATCH]).pin_memory()
                copy_ms = cuda_ms(lambda: pinned.to(dev, non_blocking=True), reps=5, inner=4)
                raw = SERVE_BATCH * 1e3 / raw_ms
                log(f"time: resnet50 W8A8 packed forward (bf16 carry, fused tail, normalize on "
                    f"the card) {raw_ms:.3f} ms a batch of {SERVE_BATCH} back to back, {raw:.1f} "
                    f"img/s; the batch's pinned host-to-device copy ({images[:SERVE_BATCH].nbytes / 1e6:.1f} MB) "
                    f"{copy_ms:.3f} ms ({images[:SERVE_BATCH].nbytes / copy_ms / 1e6:.1f} GB/s) "
                    f"[{card}]")
                for in_flight, (rate, st) in rates.items():
                    log(f"serving efficiency (host ingress, uint8), max_in_flight {in_flight}: "
                        f"engine {rate:.1f} / raw {raw:.1f} img/s = {rate / raw:.4f}; mean fill "
                        f"{st['mean_batch_fill']:.4f}, max in flight {st['max_observed_in_flight']}, "
                        f"host staging {st['staging_ms']:.3f} ms a batch [{card}]")
                device_feed(model, images, pre, card, dev)
                one_device_mesh(qtt, model, deploy, images, served[name], kw, card)
    del images, served


def bad_request(model, images, want, kw, label: str) -> None:
    """One request of the wrong shape fails its batch only: queued beside a
    good one before the engine starts (one batch), then the next
    ``SERVE_BATCH`` requests are served right."""
    import numpy as np
    from quantize_tpu_torch.parallel import InferenceEngine

    eng = InferenceEngine(model, batch_size=SERVE_BATCH, **kw)
    f_good = eng.submit(images[0])
    f_bad = eng.submit(images[0][:8, :8])
    with eng:
        errors = []
        for f in (f_good, f_bad):
            try:
                f.result(timeout=300)
            except ValueError as exc:
                errors.append(str(exc))
        (chunk,) = [f.result(timeout=300) for f in eng.submit_batch(images[:SERVE_BATCH])]
    log(f"{label}: a request of shape (8, 8, 3) failed its batch ({len(errors)} of 2 futures "
        f"raised: {errors[:1]}), failed count {eng.n_failed}; the next {SERVE_BATCH} requests "
        f"served")
    check(len(errors) == 2 and "shape" in errors[0] and eng.n_failed == 2,
          f"{label}: the bad request did not fail its batch alone")
    check(np.array_equal(chunk, want[:SERVE_BATCH]),
          f"{label}: the requests after the bad one differ from the direct forward")


def device_feed(model, images, pre, card, dev) -> None:
    """Phase 9b: requests are int32 indices into a pool of ``FRAME_POOL``
    uint8 frames on the card, the postprocess the argmax."""
    import numpy as np
    import torch
    from quantize_tpu_torch.ops import launch_counts, reset_launch_counts
    from quantize_tpu_torch.parallel import InferenceEngine

    pool = torch.from_numpy(images[:FRAME_POOL]).to(dev)
    idx = np.random.default_rng(10).integers(0, FRAME_POOL, SERVE_IMAGES).astype(np.int32)
    post = lambda o: o.argmax(-1)  # noqa: E731
    want = direct_rows(model, pre, idx, SERVE_BATCH, dev, post=post, pool=pool)
    kw = dict(max_wait_ms=2.0, preprocess=pre, postprocess=post, frame_pool=pool, device=dev)
    label = "engine resnet50 W8A8 device feed (bf16 carry, fused tail, argmax)"
    torch.cuda.synchronize()
    reset_launch_counts()
    with InferenceEngine(model, batch_size=SERVE_BATCH, **kw) as eng:
        got = np.concatenate([f.result(timeout=300) for f in eng.submit_batch(idx)])
    torch.cuda.synchronize()
    served_gates(eng, launch_counts(), RESNET_PER_FWD, label, ("conv1x1_residual", "w8a8_gemm"))
    check(np.array_equal(got, want), f"{label}: {int((got != want).sum())} labels differ from "
          f"the argmax of the direct forward")
    log(f"{label}: {len(got)} labels equal the argmax of the direct forward")
    rates = engine_rates(model, idx, label, card, SERVE_BATCH, **kw)
    x = torch.from_numpy(idx[:SERVE_BATCH]).to(dev)
    with torch.inference_mode():
        raw_ms = cuda_ms(lambda: post(model(pre(pool.index_select(0, x.long())), mode="packed")),
                         reps=5, inner=4)
    raw = SERVE_BATCH * 1e3 / raw_ms
    for in_flight, (rate, st) in rates.items():
        log(f"serving efficiency (device feed), max_in_flight {in_flight}: engine {rate:.1f} / "
            f"raw {raw:.1f} img/s = {rate / raw:.4f} (raw: gather, forward and argmax back to "
            f"back, {raw_ms:.3f} ms a batch); max in flight {st['max_observed_in_flight']} (>= 2) "
            f"[{card}]")
        check(st["max_observed_in_flight"] >= 2,
              f"{label}: the dispatch thread never ran ahead of the device "
              f"(max_in_flight {in_flight})")
    del pool


def one_device_mesh(qtt, model, deploy, images, served, kw, card) -> None:
    """Phase 9c: a fresh ResNet-50 given the deploy variables placed on a
    one-device mesh serves results bit-equal to 9a's; a mesh of two devices
    cannot be made on one card."""
    import numpy as np
    import torch
    from quantize_tpu_torch.parallel import InferenceEngine, make_mesh, shard_variables

    mesh = make_mesh(1, 1)
    fresh = qtt.MODELS.build("resnet50", num_classes=1000, ctx=qtt.QuantCtx(CFG))
    n = 4 * SERVE_BATCH
    kw = {k: v for k, v in kw.items() if k != "device"}  # the mesh's device
    eng = InferenceEngine(fresh, shard_variables(mesh, deploy), batch_size=SERVE_BATCH, mesh=mesh,
                          **kw)
    direct_rows(fresh, kw["preprocess"], images[:SERVE_BATCH], SERVE_BATCH, mesh.device)  # warm
    with eng:
        got = np.concatenate([f.result(timeout=300) for f in eng.submit_batch(images[:n])])
    check(eng.n_failed == 0, "engine on a one-device mesh: requests failed")
    check_rows(got, served[:n], f"engine resnet50 on a one-device mesh {mesh}")
    try:
        make_mesh(2, 1)
    except ValueError as exc:
        log(f"make_mesh(2, 1) on {torch.cuda.device_count()} card(s) raised: {exc}")
    else:
        raise Failure("make_mesh(2, 1) did not raise on one card")
    del fresh, eng
    torch.cuda.empty_cache()


def vit_serving_phase(qtt, batch, card, dev) -> None:
    """Phase 9e: ViT-B/16 W4A8 through the engine, two chunks of
    ``VIT_SERVE_BATCH``, at f32 carry."""
    import numpy as np
    import torch
    from quantize_tpu_torch.ops import launch_counts, reset_launch_counts
    from quantize_tpu_torch.parallel import InferenceEngine

    model = build_packed(qtt, batch, "vit_b_16", CFG_W4A8, "vit_b_16 W4A8 (engine)")
    images = np.random.default_rng(11).integers(
        0, 256, (2 * VIT_SERVE_BATCH, SERVE_IMAGE, SERVE_IMAGE, 3), dtype=np.uint8)
    pre = normalizer(dev)
    want = direct_rows(model, pre, images, VIT_SERVE_BATCH, dev)
    torch.cuda.synchronize()
    reset_launch_counts()
    with InferenceEngine(model, batch_size=VIT_SERVE_BATCH, input_dtype=np.uint8,
                         preprocess=pre, device=dev) as eng:
        futs = eng.submit_batch(images)
        got = np.concatenate([f.result(timeout=300) for f in futs])
    torch.cuda.synchronize()
    label = "engine vit_b_16 W4A8 (f32 carry)"
    served_gates(eng, launch_counts(), VIT_PER_FWD, label, ("w4a8_gemm", "layernorm_quant_int8"))
    check(len(futs) == 2 and eng.n_batches == 2, f"{label}: {len(futs)} chunks, "
          f"{eng.n_batches} batches")
    check_rows(got, want, label)
    del model
    torch.cuda.empty_cache()


def write_cifar10(root, seed: int) -> None:
    """A CIFAR-10 python-format archive: ``data_batch_1..5`` and
    ``test_batch`` of ``CIFAR_PER_FILE`` seeded images each, in the standard
    pickle layout (``data`` (n, 3072) uint8 rows, channel planes of 32 x 32;
    ``labels`` a list of ints)."""
    import os
    import pickle

    import numpy as np

    rng = np.random.default_rng(seed)
    d = os.path.join(root, "cifar-10-batches-py")
    os.makedirs(d)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(os.path.join(d, name), "wb") as f:
            pickle.dump({b"batch_label": name.encode(),
                         b"labels": rng.integers(0, 10, CIFAR_PER_FILE).tolist(),
                         b"data": rng.integers(0, 256, (CIFAR_PER_FILE, 3072), dtype=np.uint8),
                         b"filenames": [f"{i}.png".encode() for i in range(CIFAR_PER_FILE)]}, f)


def cifar_phase(qtt, card, dev) -> None:
    """Phase 9d: the PTQ runner through the CLI on ``CIFAR_CFG`` over a
    CIFAR-10 archive the script writes, its batches through
    ``PrefetchIterator``; then the best checkpoint packed and evaluated over
    the test split."""
    import os
    import pickle
    import re
    import tempfile

    import numpy as np
    import torch
    import quantize_tpu_torch.parallel.input_pipeline as input_pipeline
    import quantize_tpu_torch.runners as runners
    from quantize_tpu_torch import cli
    from quantize_tpu_torch.data import DATASETS, TRANSFORMS
    from quantize_tpu_torch.ops import launch_counts, reset_launch_counts

    missing = [n for n in DATASET_NAMES if n not in DATASETS]
    check(not missing, f"datasets not registered: {missing}")
    try:
        import PIL  # noqa: F401
        pillow = "present"
    except ImportError:
        pillow = "absent"
    log(f"quantize_tpu_torch.data imported with Pillow {pillow}; the nine dataset names "
        f"registered")

    built, prefetched = [], [0]
    build_runner, prefetch_cls = runners.build_runner, input_pipeline.PrefetchIterator

    class Counting(prefetch_cls):
        def __next__(self):
            item = super().__next__()
            prefetched[0] += 1
            return item

    def keep(*args, **kw):
        built.append(build_runner(*args, **kw))
        return built[-1]

    with tempfile.TemporaryDirectory() as data_dir, tempfile.TemporaryDirectory() as out_dir:
        t0 = time.time()
        write_cifar10(data_dir, seed=12)
        log(f"cifar: a CIFAR-10 archive of 5 x {CIFAR_PER_FILE} train and {CIFAR_PER_FILE} test "
            f"images written in {time.time() - t0:.2f} s")
        argv = ["--cfg", CIFAR_CFG, "--output-dir", out_dir, "--device", str(dev), "--opts",
                *(f"{s}_dataset.root={data_dir}" for s in ("train", "val", "test"))]
        runners.build_runner, input_pipeline.PrefetchIterator = keep, Counting
        try:
            t0 = time.time()
            cli.main(argv)
            torch.cuda.synchronize()
            wall = time.time() - t0
        finally:
            runners.build_runner, input_pipeline.PrefetchIterator = build_runner, prefetch_cls
        found = re.findall(r"test result: \{'top1': ([-+.\deE]+|nan), 'n': (\d+)\}",
                           open(os.path.join(out_dir, "output.log")).read())
        check(len(found) == 1, "cifar: no test result in output.log")
        top1, n_test = float(found[0][0]), int(found[0][1])
        log(f"cifar resnet18 W8A8 (ptq_rn18_w8a8_cifar10.yaml): config to test result {wall:.2f} s, "
            f"test top-1 {top1:.2f}% over {n_test} (quant mode, random weights); {prefetched[0]} "
            f"batches through PrefetchIterator [{card}]")
        check(0.0 <= top1 <= 100.0 and n_test == CIFAR_PER_FILE,
              f"cifar: test top-1 {top1} over {n_test}")
        check(prefetched[0] > 0, "cifar: no batch went through PrefetchIterator")

        runner = built[0]
        cfg = runner.cfg
        first = next(runner._prefetch(runner.test_loader))
        with open(os.path.join(data_dir, "cifar-10-batches-py", "test_batch"), "rb") as f:
            raw = pickle.load(f, encoding="bytes")
        n = runner.test_loader.batch_size
        imgs = raw[b"data"][:n].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        for name, args in cfg.test_dataset.transform.to_dict().items():
            imgs = TRANSFORMS.build(name, **(args or {}))(imgs)
        check(first["img"].device == dev, "cifar: the batch is not on the card")
        check(np.array_equal(first["img"].cpu().numpy(), np.asarray(imgs, np.float32))
              and np.array_equal(first["label"].cpu().numpy(), np.asarray(raw[b"labels"][:n])),
              "cifar: the first test batch differs from a numpy decode of the archive")
        log(f"cifar: the first test batch ({tuple(first['img'].shape)}) equals a numpy decode of "
            f"the archive with the config's to_tensor and normalize")

        fresh = runners.build_runner(cfg, device=dev)
        fresh.load_checkpoint(cfg.runner.best)
        qtt.pack_model(fresh.model, next(runner._prefetch(runner.train_loader))["img"], device=dev)
        correct = total = batches = 0
        with torch.inference_mode():
            torch.cuda.synchronize()
            reset_launch_counts()
            for b in runner._prefetch(runner.test_loader):
                logits = fresh.model(b["img"], mode="packed")
                valid = b["label"] >= 0
                correct += int((logits.argmax(-1) == b["label"])[valid].sum())
                total += int(valid.sum())
                batches += 1
            torch.cuda.synchronize()
        counts = launch_counts()
        log(f"cifar: packed eval of the best checkpoint over {total} test images in {batches} "
            f"batches: top-1 {100.0 * correct / total:.2f}%, launches {counts}")
        for name, per in RESNET18_PER_FWD.items():
            check(counts[name] == per * batches,
                  f"cifar packed eval: {name} {counts[name]} launches, expected {per} x {batches}")
        for name, c in counts.items():
            check(name in RESNET18_PER_FWD or c == 0, f"cifar packed eval: {name} launched {c}")
        del runner, fresh, built
    torch.cuda.empty_cache()


def packing_phase(deploy, card) -> None:
    """Phase 9f: the native dense packer over the packed ResNet-50's
    ``w_int`` leaves at 8 and 4 bits (clamped), against the plain version."""
    import torch
    from quantize_tpu_torch import engine
    from quantize_tpu_torch.quant.pack import tpack as plain_tpack

    t0 = time.time()
    check(engine.get_native() is not None, "the native tpack library did not build")
    log(f"native tpack built (g++) and loaded in {time.time() - t0:.2f} s: {engine.lib_path()}")
    leaves = [t.cpu() for k, t in deploy["packed"].items() if k.endswith("w_int")]
    n = sum(t.numel() for t in leaves)
    for bits in (8, 4):
        lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
        t0 = time.perf_counter()
        packed = [engine.tpack(w, bits, True) for w in leaves]
        t_pack = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = [engine.tunpack(p, d, torch.int8) for p, d in packed]
        t_unpack = time.perf_counter() - t0
        t0 = time.perf_counter()
        plain = [plain_tpack(w, bits, True)[0] for w in leaves]
        t_plain = time.perf_counter() - t0
        check(all(torch.equal(b, w.clamp(lo, hi)) for b, w in zip(back, leaves)),
              f"native tpack/tunpack at {bits} bits: the round trip differs")
        check(all(torch.equal(p, q) for (p, _), q in zip(packed, plain)),
              f"native tpack at {bits} bits: bytes differ from the plain version's")
        out_mb = sum(p.numel() for p, _ in packed) / 1e6
        log(f"time: dense packing of {len(leaves)} w_int leaves ({n / 1e6:.2f} M int8) at {bits} "
            f"bits into {out_mb:.2f} MB, bit for bit: native tpack {n / 1e6 / t_pack:.1f} MB/s, "
            f"tunpack {n / 1e6 / t_unpack:.1f} MB/s, the plain torch version {n / 1e6 / t_plain:.1f}"
            f" MB/s (host, {torch.get_num_threads()} threads) [{card}]")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on an NVIDIA GPU",
              file=sys.stderr)
        return 2
    try:
        import quantize_tpu_torch as qtt
        from quantize_tpu_torch.ops import _build
    except ImportError as exc:
        print(f"chip_smoke: the quantize_tpu_torch package is not here ({exc})", file=sys.stderr)
        return 2

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi gave nothing"
    log(f"card: {card}")
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda} "
        f"devices {torch.cuda.device_count()}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")

    t0 = time.time()
    reports = _build.build_all()
    log(f"build: {len(reports)} kernel libraries in {time.time() - t0:.1f} s")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "Used" in line:
                log(f"  {name}: {line.split(':', 1)[-1].strip()}")
    for name in _build.KERNELS:
        _build.kernel_fn(name)

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def batch(n):
        return torch.randn((n, 224, 224, 3), generator=gen, device=dev)

    t0 = time.time()
    entries = resnet_phase(qtt, batch, card)
    log(f"resnet50 phase {time.time() - t0:.1f} s")
    t0 = time.time()
    n = conv1x1_phase(dev)
    log(f"conv1x1 phase: {n} kernel-vs-plain comparisons passed, {time.time() - t0:.1f} s")
    t0 = time.time()
    n = w8a8_phase(dev, card)
    log(f"w8a8 phase: {n} kernel-vs-plain comparisons passed, {time.time() - t0:.1f} s")
    t0 = time.time()
    entries += resnext_phase(qtt, batch, card, dev)
    log(f"resnext50_32x4d phase {time.time() - t0:.1f} s")
    t0 = time.time()
    n = grouped_phase(dev, card)
    log(f"grouped phase: {n} kernel-vs-plain comparisons and refusals passed, "
        f"{time.time() - t0:.1f} s")
    t0 = time.time()
    mobilenet_phase(qtt, batch, card)
    log(f"mobilenet_v2 phase {time.time() - t0:.1f} s")
    t0 = time.time()
    wrn_phase(qtt, card, dev)
    log(f"wideresnet28 phase {time.time() - t0:.1f} s")
    t0 = time.time()
    runner_phase(qtt, card, dev)
    log(f"runner phase {time.time() - t0:.1f} s")
    t0 = time.time()
    vit_entries, vit_err = vit_phase(qtt, batch, card)
    entries += vit_entries
    log(f"vit_b_16 phase {time.time() - t0:.1f} s")
    t0 = time.time()
    n = w4a8_phase(dev)
    log(f"w4a8 phase: {n} kernel-vs-plain comparisons passed, {time.time() - t0:.1f} s")
    t0 = time.time()
    entries += vit32_phase(qtt, batch, card, vit_err)
    log(f"vit_b_32 phase {time.time() - t0:.1f} s")
    t0 = time.time()
    clip_phase(qtt, batch, card, dev)
    log(f"clip_vit-b16 phase {time.time() - t0:.1f} s")
    t0 = time.time()
    clip_rn_phase(qtt, batch, card, dev)
    log(f"clip_rn50 phase {time.time() - t0:.1f} s")
    t0 = time.time()
    long_attention_phase(qtt, card, dev)
    log(f"long attention phase {time.time() - t0:.1f} s")
    t0 = time.time()
    qat_phase(qtt, card, dev)
    log(f"qat phase {time.time() - t0:.1f} s")
    t0 = time.time()
    adaround_phase(qtt, card, dev)
    log(f"adaround phase {time.time() - t0:.1f} s")
    t0 = time.time()
    train_cli_phase(card, dev)
    log(f"training runs through the CLI {time.time() - t0:.1f} s")
    t0 = time.time()
    resnet, deploy, x, carry_ms = carry_resnet_phase(qtt, batch, card)
    log(f"carry resnet50 phase {time.time() - t0:.1f} s")
    t0 = time.time()
    carry_mobilenet_phase(qtt, batch, card)
    log(f"carry mobilenet_v3_large phase {time.time() - t0:.1f} s")
    t0 = time.time()
    fault_phase(qtt, card, dev)
    log(f"fault-tolerant runs {time.time() - t0:.1f} s")
    t0 = time.time()
    unpack_profile_phase(qtt, resnet, deploy, x, carry_ms, card, dev)
    log(f"unpack and profiling phase {time.time() - t0:.1f} s")
    t0 = time.time()
    serving_phase(qtt, resnet, deploy, card, dev)
    log(f"serving phase (engine, device feed, one-device mesh) {time.time() - t0:.1f} s")
    t0 = time.time()
    packing_phase(deploy, card)
    log(f"dense packing phase {time.time() - t0:.1f} s")
    del resnet, deploy, x
    torch.cuda.empty_cache()
    t0 = time.time()
    vit_serving_phase(qtt, batch, card, dev)
    log(f"vit_b_16 serving phase {time.time() - t0:.1f} s")
    t0 = time.time()
    cifar_phase(qtt, card, dev)
    log(f"cifar runner phase {time.time() - t0:.1f} s")
    log("kernel times above are per launch; the JSON sums them over one forward of each model "
        "(each shape's time x its launches per forward; K3 and KQ are ResNet-50's, K3g "
        "ResNeXt-50's, "
        "K5 ViT-B/32's; "
        "launches are each model's 4 served requests, K9's the one int8-scores request)")
    print(json.dumps({"kernels": entries}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Failure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr, flush=True)
        sys.exit(1)
