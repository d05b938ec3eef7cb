#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one GPU and hold each kernel against its plain version.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card, ``nvcc`` and a C compiler (for the RLE codec); it
builds the five kernel libraries of ``torchmetrics_tpu_torch/csrc/`` (one
``nvcc`` each, started together). It
exits non-zero, printing no result, where ``torch.cuda.is_available()`` is
false or the package is not beside it.

Phases, one JSON line each; any mismatch raises and the script exits non-zero:

1. ``build``: compile the five kernel libraries (the build line gives each library's
   ``nvcc`` time, kernel count, most registers and largest spill, and, for the
   kernels redesigned for Hopper, each one's registers, spills and shared
   memory), print the card's name and power limit;
2. ``kernel_vs_plain``: the confmat kernel against its plain PyTorch version on the card,
   counts exactly, float32 weights within a stated tolerance;
3. ``imagenet_val``: torchvision's classification evaluation (50,000 samples,
   1000 classes, batches of 1024) through ``MulticlassAccuracy`` top-1/top-5
   and ``MulticlassConfusionMatrix``, half by ``forward``, half by ``update``,
   checked exactly against ``numpy`` on the host;
3a. ``confmat_exact_2p24``: 2**24 + 3 rows, all (1, 1), in one update of
   ``BinaryConfusionMatrix`` and ``MulticlassConfusionMatrix`` at 3 and 300
   classes (B1): exactly 16,777,219 in cell (1, 1);
3b. ``classification_collection``: BASELINE config 2 on the same deployment, a
   ``MetricCollection`` of micro accuracy, macro precision/recall/F1, binned
   (100 thresholds) and exact AUROC and two confusion matrices, half by
   ``forward``, half by ``update``: counts exact against ``numpy``, ratios and
   AUROC (binned against ``numpy`` on the same thresholds, exact against a
   float64 rank sum) within stated tolerances, the compute groups of the CPU
   tests, B1 launched once an ``update`` batch and once a confusion-matrix
   member a ``forward`` batch, results equal to the metrics outside a
   collection; batches/s, update and forward ms, each AUROC's ``compute`` ms,
   peak memory;
3c. ``aggregation``: Mean, Sum, Max, Cat and ``RunningMean(window=5)`` over 49
   batches of losses made on the card, one with NaNs under
   ``nan_strategy="ignore"``, against float64 on the host;
4. ``ade20k_full``: 847-class semantic segmentation, 8 updates of 16 label maps
   of 512x512 with void pixels under ``ignore_index=-1``, checked exactly
   against the plain version on the card;
4a. ``ade20k_miou``: the same maps through one ``MetricCollection`` of the
   confusion matrix, macro and per-class Jaccard (mean IoU), MCC and Cohen's
   kappa: one compute group, B1 once an update (every member once on the
   first, which finds the groups), values against float64 numpy from the
   exact matrix and equal to each metric run alone; mIoU, updates/s, peak memory;
4b. ``classification_rest``: the imagenet_val data through one collection of
   MCC, kappa and Jaccard (B1), specificity and Hamming, average precision
   (100 thresholds and exact), recall at precision 0.5, specificity at
   sensitivity 0.5, ECE and MCE (15 bins) and the hinge loss, each against
   float64 numpy computed in worker processes while the card streams;
   batches/s and each metric's ``compute`` ms;
4c. ``coco_multilabel``: MS-COCO 2014's multilabel evaluation shape (40,504
   images, 80 labels, ~2.9 positive an image, batches of 256): average
   precision exact and binned, precision at recall 0.5, the three ranking
   metrics, exact match, Hamming, Jaccard, MCC and specificity against
   float64 numpy; images/s and ``compute`` ms;
4d. ``dice_fairness``: Dice (150 classes, macro) on SceneParse150-shaped maps,
   counts exact, and the peak memory of its one-hot temporaries;
   ``BinaryFairness``/``BinaryGroupStatRates`` on CelebA's test shape (19,962
   samples) with 2 and 4 groups, counts exact;
5. ``timing``: the confmat kernel at the main path's two shapes, added into a
   state (``queued_ms``) and as a fresh matrix, beside the bytes bound with and
   without the matrix, its plain version and ``torch.bincount``;
6. ``confmat_distributions``: the confmat kernel and the one-atomic-per-row
   design it replaced at one ADE20K-Full update on three label laws (the
   ade20k_full maps, uniform pairs, 16x16-coherent maps), exact, timed;
7. ``conv_epilogue_vs_plain``: kernels B2a (GEMM + bias + ReLU) and B2b
   (bias + ReLU) against their plain versions at every distinct shape of one
   InceptionV3 forward at batch 200, bf16 and float32, plus odd tails;
8. ``lpips_head_vs_plain``: kernel B3 at every tap shape of the alex, vgg and
   squeeze trunks at 256x256, 50 pairs, on float32 and bf16 maps, each call
   repeated for identical bits;
9. ``fid_cifar10_10k``: ``FrechetInceptionDistance(feature=2048)`` over 10,000
   real and 10,000 perturbed uint8 3x32x32 images in updates of 200, launch
   counts exact, the bf16 fused trunk against the float32 unfused one, the
   FID against a float64 host recomputation from the metric's states;
10. ``lpips_pairs``: ``LearnedPerceptualImagePatchSimilarity()`` (alex) over
    1,000 pairs of 3x256x256 images in batches of 50, one batch each of vgg
    and squeeze, launch counts exact, against ``LPIPSNet(unfused=True)``; the
    head stage alone must run B3 5 times and no copy, fill or division kernel.
    Phases 9 and 10 also give one update's device time by kernel
    (``torch.profiler``) and the share of its wall time the card sat idle;
11. ``image_timing``: CUDA-event medians of B2a, B2b and B3 at their main-path
    shapes, beside their bounds, plain versions and library calls, summed over
    one forward (B3 on bf16 maps, float32 beside), and B2a by activation size
    (73x73, 35x35, 17x17, 8x8);
12. ``attention_vs_plain``: kernel B4 (masked attention) against its plain version
    at the path's shapes, (2999, 128, 768)/12 heads of ``compute`` and
    (100, 128, 768) of a ``forward``, with the WMT corpus's ragged masks, at
    L 1, 37 and 509, at hidden 96/4 heads, with fully masked rows, float32
    and bf16; a view that is not 4-element aligned is refused;
13. ``layernorm_residual_vs_plain``: kernel B5 at the path's (383872, 768) and at
    C 70, 1000, 1024 and 2000, float32, bf16 and mixed inputs;
14. ``bertscore_wmt``: ``BERTScore(model=BertEncoderExtractor(npz))`` on seeded
    random bert-base-uncased weights over 2,999 pre-tokenized pairs (the size of
    WMT16 newstest2016 de-en) in updates of 100, half by ``forward``, then
    ``compute``, with ``idf`` off and on: launch counts exact, scores against the
    unfused float32 encoder on the card, one ``compute``'s device time by kernel;
15. ``infolm_pairs``: ``InfoLM`` (KL, idf, temperature 0.25) on the same weights'
    MLM head over 128 pairs of up to 64 wordpieces, launch counts exact, against
    the unfused MLM on the card;
16. ``text_timing``: CUDA-event medians of B4 and B5 at one BERTScore encoder
    forward's shapes, beside their bounds, plain versions and library calls, and
    of B4 on bf16 inputs beside bf16 ``scaled_dot_product_attention``;
17. ``detection_coco_val``: BASELINE config 3, ``MeanAveragePrecision(iou_type="bbox")``
    on a COCO val2017-shaped stream made on the card (5,000 images, 80 classes,
    100 detections and 1-50 ground truths an image, ~1% crowd, updates of 16):
    the 12 summary values against the port's own CPU run of the same updates
    (1e-6) and, on a 500-image subset, against the numpy pycocotools port of
    ``tests/unittests/detection/`` (1e-5); ``class_metrics=True`` on the same
    states; images/s, ``compute`` ms, peak memory, one ``compute``'s device time
    by kernel and idle share. The host references run in worker processes
    while the card works through phases 17-21, and are read at the end;
18. ``detection_segm``: ``iou_type="segm"`` on 100 images of 427x640 masks (20
    detections, 1-10 ground truths each) against the pycocotools port (1e-4),
    and the masks' round trip through ``tm_to_coco``/``coco_to_tm`` and the
    port's C RLE codec, exact;
19. ``detection_stream``: 1,000 updates of 1 image (100 detections, 20 ground
    truths), updates/s, the result equal to one update of all 1,000 images;
20. ``iou_panoptic``: IoU, GIoU, DIoU and CIoU (functional matrices and classes
    with ``class_metrics``) on 16 images of 100 x 100 boxes against float64
    numpy (1e-6); ``PanopticQuality`` and ``ModifiedPanopticQuality`` on 8
    COCO-panoptic-like 512x512 maps, states equal to the CPU run; golden cases
    158-163 replayed on the card;
21. ``text_no_model``: ``BERTScore()`` and ``InfoLM()`` built without a model (the
    hash encoders) on 64 pairs of the bertscore_wmt and infolm_pairs corpora,
    token ids exact and scores within 1e-6 / 1e-5 of the port's CPU run;

then the card's name and power limit, the ``kernels`` line and, last,
``{"ok": true, "device": {...}}``. Trunk weights are seeded random ones: no
checkpoint can be downloaded. Floats are printed to 7 significant digits.
"""

from __future__ import annotations

import argparse
import collections
import importlib
import json
import os
import re
import statistics
import multiprocessing
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory, NVIDIA data sheet
FLOAT_RTOL = 1e-4  # float32 cell sums of up to ~1000 weights: the kernel's atomics vs the plain float64 bincount
FLOAT_ATOL = 1e-4
BF16_FLOPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core peak, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores: B2b's and B3's arithmetic
TF32_FLOPS_PER_S = 495e12  # H100 SXM dense TF32 tensor-core peak: B4's float32 products, three passes (3xTF32)
GEMM_F32_RTOL = 1e-5  # of the output's scale: float32 sums of up to 2048 products, in another order
GEMM_BF16_ULP = 2.0**-7  # of each value: the float32 sums differ, so one bf16 rounding may flip
HEAD_RTOL = 1e-5  # the JAX package's own tolerance for the LPIPS head
TRUNK_F32_RTOL = 1e-3  # fused (kernels) vs unfused float32 trunk, by relative norm; the chaos below grows f32 roundings too
# bf16 fused trunk vs float32 unfused trunk, by relative norm. With calibrated BatchNorm a random
# InceptionV3 is chaotic: BN + ReLU grows a relative perturbation ~1.2x per layer, so bf16's 2**-9
# roundings reach ~0.2 at the 2048 tap. Wrong weights or a wrong layout give ~1.
TRUNK_BF16_RTOL = 0.5
FID_RTOL = 1e-2  # the metric's float32 FID vs a float64 host recomputation from its own states
ATT_F32_RTOL = 1e-5  # of the output's scale: float32 sums of L*d products and L exps, in another order
ATT_BF16_ULP = 2.0**-7  # of each value: kernel and plain both round one float32 value to bf16, which may flip
LN_RTOL = 1e-5  # of the output's scale: float32 row sums in another order, rsqrtf within 2 ulp
# fused (B4/B5) vs unfused float32 encoder: hidden states agree to ~1e-6 relative, and
# precision/recall/F1 are weighted means of cosines in [-1, 1]
BERTSCORE_ATOL = 1e-4
# InfoLM KL per sentence, fused vs unfused float32 MLM: logits ~1e-6 apart, divided by the 0.25 temperature
INFOLM_RTOL, INFOLM_ATOL = 1e-4, 1e-5
BERT_BASE = dict(vocab_size=30522, hidden_size=768, num_layers=12, num_heads=12, intermediate_size=3072,
                 max_position=512, type_vocab=2)  # bert-base-uncased's published config
SPECIAL_IDS = {"pad_token_id": 0, "cls_token_id": 101, "sep_token_id": 102, "mask_token_id": 103}  # its vocab's
# classification_collection: macro precision/recall/F1 and the normalized confusion matrix against float64 numpy
# (float32 divisions and a 1000-term float32 mean); binned AUROC against numpy on the same thresholds (float32
# rates and a 100-step trapezoid); exact AUROC against a float64 Mann-Whitney rank sum, ties averaged
COLLECTION_RATIO_ATOL = 1e-6
BINNED_AUROC_ATOL = 1e-6
EXACT_AUROC_ATOL = 1e-5
AGG_RTOL = 1e-6  # aggregation: float32 sums of 16 and 49 positive terms against float64
# the rest of classification against float64 numpy on the host. Ratios in [0, 1] of exact integer counts (IoU,
# specificity, Hamming, binned curves, the operating points, Dice, fairness rates): one float32 division and a
# float32 mean
SLICE6_ATOL = 1e-6
MCC_KAPPA_RTOL = 1e-5  # ade20k_miou: float32 products of ~3e7-pixel sums (s**2 ~ 9e14) and 847-term dot products
EXACT_AP_ATOL = 1e-5  # exact AP against a float64 sort and cumulative sum: float32 precision at each positive
# ECE/MCE: float32 per-bin sums (``index_add_``), whose order of adds on the card varies from run to run. The top
# bin holds ~38,000 confidences just under 1: added one after another in float32 (a resolution of ~4e-3 past
# 2**15) each would round up, ~5e-5 of the bin's mean in all; the card's adds were measured 2.4e-7 off float64
# on an H100
CALIBRATION_ATOL = 2e-5
SUM_RTOL = 1e-5  # the hinge and ranking means: float32 running sums over 40,000-50,000 samples against float64


def _float32_digits(obj):
    """Floats to 7 significant digits, a float32's precision: CUDA events and the kernels' outputs are float32."""
    if isinstance(obj, float):
        return float(f"{obj:.7g}")
    if isinstance(obj, dict):
        return {k: _float32_digits(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_float32_digits(v) for v in obj]
    return obj


def emit(obj: dict) -> None:
    print(json.dumps(_float32_digits(obj)), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def median_ms(torch, fn, reps: int, warmup: int = 3) -> float:
    """Median over ``reps`` calls of ``fn``, each bracketed by CUDA events, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    for start, end in zip(starts, ends):
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def queued_ms(torch, fn, reps: int = 30, warmup: int = 3) -> float:
    """Median device time of ``fn`` with the host's launches queued ahead of the card.

    A spin kernel (``torch.cuda._sleep``) holds the stream while every call
    and its two events are enqueued, so each pair of events brackets the
    kernels alone: for a call shorter than its host-side launch cost,
    :func:`median_ms` measures the host instead.
    """
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    torch.cuda._sleep(int(reps * 2e5))  # ~0.1 ms a call at the H100's clock: more than a wrapper's host cost
    for start, end in zip(starts, ends):
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def wall_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Median host-clock time of ``fn`` followed by a device synchronize: what one call costs its caller."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def ptxas_summary(log: str) -> dict:
    """Kernel count, most registers and largest spill of one library, from ``nvcc -Xptxas -v``'s log."""
    regs = [int(n) for n in re.findall(r"Used (\d+) registers", log)]
    spills = [int(n) for n in re.findall(r"(\d+) bytes spill stores", log)]
    return {"kernels": len(regs), "max_registers": max(regs, default=0), "max_spill_bytes": max(spills, default=0)}


def ptxas_templates(log: str, name: str) -> dict:
    """Registers, spill bytes and static shared memory of each instantiation of kernel template ``name``, from ptxas -v.

    Keys are ``name<args>`` with the template arguments read from the mangled
    name: ``f`` float32, ``i``/``l`` int32/int64 labels, ``Bf16`` bf16, ``Li<n>E`` n.
    """
    names = {"f": "f32", "i": "i32", "l": "i64"}
    found, key = {}, None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            args = re.search(name + r"I(.*?)EEv", entry.group(1))
            key = None
            if args:
                tokens = re.findall(r"Li(\d+)E|N\S*?4Bf16E|([fil])", args.group(1) + "E")
                key = f"{name}<{','.join(num or names.get(tag, 'bf16') for num, tag in tokens)}>"
            continue
        if key is not None:
            spill = re.search(r"(\d+) bytes spill stores", line)
            regs = re.search(r"Used (\d+) registers", line)
            smem = re.search(r"(\d+) bytes smem", line)
            if spill:
                found.setdefault(key, {})["spill_bytes"] = int(spill.group(1))
            if regs:
                found.setdefault(key, {})["registers"] = int(regs.group(1))
                found[key]["static_smem_bytes"] = int(smem.group(1)) if smem else 0
    return found


def bound_ms(cost, flops_per_s: float):
    """The least time for a call's work: the larger of its operations over peak and its bytes over HBM rate."""
    t_ops = cost.flops / flops_per_s * 1e3
    t_bytes = cost.bytes_accessed / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops > t_bytes else "bytes")


def rel_norm(torch, got, want) -> float:
    return float(torch.linalg.vector_norm((got - want).double()) / torch.linalg.vector_norm(want.double()))


def device_time_by_kernel(torch, fn, top: int = 10) -> dict:
    """Device time of one call of ``fn`` by kernel (``torch.profiler``), and the share of its wall time the card idled.

    Only the device rows count: the row of a PyTorch op repeats the time of
    the kernels it launched. The wall time is taken under the profiler.
    """
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = sorted(
        ((evt.key, evt.self_device_time_total / 1e3, evt.count) for evt in prof.key_averages()
         if evt.device_type == DeviceType.CUDA and evt.self_device_time_total > 0),
        key=lambda r: -r[1],
    )
    busy = sum(r[1] for r in rows)
    return {  # no rows: the profiler saw no device time here, and the CUDA-event timings stand alone
        "wall_ms": wall, "device_busy_ms": busy if rows else None,
        "idle_share": 1.0 - busy / wall if rows else None, "kernels": len(rows),
        "top": [{"kernel": name[:64], "ms": ms, "calls": calls} for name, ms, calls in rows[:top]],
    }


def inception_npz(torch, np, seed: int, folder: str, dev, gen) -> str:
    """Seeded random InceptionV3 weights as the JAX package's ``.npz``, with BatchNorm made non-trivial.

    Kernels are drawn with the flax laws and the BN scales and shifts from
    the seed. The running statistics are calibrated, as a trained network's
    are: each BatchNorm takes the mean and variance of what reaches it in one
    float32 forward over 64 seeded images. Drawn at random instead, they leave
    activations shrinking layer by layer, and the pooled features' covariance
    so ill-conditioned that float32 statistics no longer resolve it.
    """
    from torchmetrics_tpu_torch.image._inception import InceptionV3, _BatchNorm, _resize_bilinear_tf1, init_weights_
    from torchmetrics_tpu_torch.utilities.compute import full_fp32
    from torchmetrics_tpu_torch.utilities.convert import build_on_cpu, variables_from_state_dict

    net = init_weights_(build_on_cpu(InceptionV3, fuse_bn=False), seed)
    cpu_gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, value in net.state_dict().items():  # shares storage with the module
            if name.endswith("BatchNorm_0.weight"):
                value.uniform_(0.5, 1.5, generator=cpu_gen)
            elif name.endswith("BatchNorm_0.bias"):
                value.normal_(0.0, 0.1, generator=cpu_gen)

    def calibrate(module, args):
        y = args[0].float()
        module.running_mean.copy_(y.mean(dim=(0, 2, 3)))
        module.running_var.copy_(y.var(dim=(0, 2, 3), unbiased=False))

    net = net.to(device=dev, memory_format=torch.channels_last)
    hooks = [m.register_forward_pre_hook(calibrate) for m in net.modules() if isinstance(m, _BatchNorm)]
    imgs = torch.randint(0, 256, (64, 3, 32, 32), generator=gen, device=dev, dtype=torch.uint8)
    x = ((_resize_bilinear_tf1(imgs.float(), 299, 299) - 128.0) / 128.0).contiguous(memory_format=torch.channels_last)
    try:
        with torch.no_grad(), full_fp32():
            net(x, "2048")
    finally:
        for hook in hooks:
            hook.remove()
    path = os.path.join(folder, "inception.npz")
    np.savez(path, **variables_from_state_dict(net.cpu().state_dict()))
    return path


def inception_conv_calls(extractor, imgs) -> list:
    """``(x shape, weight shape, stride, padding, out shape)`` of every conv of one forward, in order."""
    from torchmetrics_tpu_torch.image._inception import BasicConv2d

    calls = []

    def record(mod, args, out):
        conv = mod.Conv_0
        calls.append((tuple(args[0].shape), tuple(conv.weight.shape), conv.stride, conv.padding, tuple(out.shape)))

    hooks = [m.register_forward_hook(record) for m in extractor.net.modules() if isinstance(m, BasicConv2d)]
    try:
        extractor(imgs)
    finally:
        for hook in hooks:
            hook.remove()
    return calls


def is_pointwise(call) -> bool:
    _, wshape, stride, padding, _ = call
    return wshape[2:] == (1, 1) and tuple(stride) == (1, 1) and tuple(padding) == (0, 0)


def gemm_shape(call):
    (n, cin, h, w), (cout, _, _, _), _, _, _ = call
    return (n * h * w, cin, cout)


def rows_shape(call):
    n, c, h, w = call[4]
    return (n * h * w, c)


def phase_conv_epilogue_vs_plain(torch, ce, calls, dev, gen) -> dict:
    pointwise = sorted({gemm_shape(c) for c in calls if is_pointwise(c)})
    spatial = sorted({rows_shape(c) for c in calls if not is_pointwise(c)})
    # odd tails: element path (K or N not a multiple of 8) and the TMA path with ragged M, K and N
    tails = [(1001, 70, 33), (129, 8, 5), (77, 1280, 447), (3, 3, 7), (1001, 64, 40), (77, 1288, 72)]
    cases, worst = [], {"mm_abs": 0.0, "mm_rel": 0.0, "br_abs": 0.0}
    for m, k, n in pointwise + tails:
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn((m, k), generator=gen, device=dev).relu_().to(dtype)  # activations are post-ReLU
            w = (torch.randn((n, k), generator=gen, device=dev) / k**0.5).to(dtype)
            b = (0.1 * torch.randn(n, generator=gen, device=dev)).to(dtype)
            got = ce.matmul_bias_relu(x, w, b)
            ref = ce.matmul_bias_relu_plain(x, w, b)
            torch.cuda.synchronize()
            err = (got.float() - ref.float()).abs()
            scale = float(ref.float().abs().max())
            if dtype == torch.float32:
                ok = float(err.max()) <= GEMM_F32_RTOL * scale
            else:
                ok = bool((err <= GEMM_BF16_ULP * ref.float().abs() + GEMM_F32_RTOL * scale).all())
            name = f"B2a ({m},{k},{n}) {str(dtype).split('.')[-1]}"
            check(ok, f"{name}: max abs err {float(err.max())} at output scale {scale}")
            worst["mm_abs"] = max(worst["mm_abs"], float(err.max()))
            worst["mm_rel"] = max(worst["mm_rel"], float(err.max()) / max(scale, 1e-30))
            cases.append({"case": name, "max_abs_err": float(err.max()), "scale": scale})
    for m, c in spatial + [(1001, 33), (77, 5)]:
        for dtype in (torch.bfloat16, torch.float32):
            y = torch.randn((m, c), generator=gen, device=dev).to(dtype)
            b = (0.1 * torch.randn(c, generator=gen, device=dev)).to(dtype)
            ref = ce.bias_relu_plain(y, b)
            got = ce.bias_relu_(y.clone(), b)
            torch.cuda.synchronize()
            name = f"B2b ({m},{c}) {str(dtype).split('.')[-1]}"
            err = float((got.float() - ref.float()).abs().max())
            check(torch.equal(got, ref), f"{name}: max abs err {err}, expected exact")
            worst["br_abs"] = max(worst["br_abs"], err)
            cases.append({"case": name, "max_abs_err": err})
    emit({
        "phase": "conv_epilogue_vs_plain", "cases": len(cases), "pointwise_shapes": len(pointwise),
        "spatial_shapes": len(spatial), "worst": worst,
        "tolerance": {
            "B2a_float32": f"max|err| <= {GEMM_F32_RTOL} * max|ref|",
            "B2a_bfloat16": f"|err| <= 2**-7 * |ref| + {GEMM_F32_RTOL} * max|ref| (one bf16 rounding step)",
            "B2b": "exact (same float32 add and one rounding)",
        },
    })
    return {"cases": cases, "worst": worst, "pointwise": pointwise, "spatial": spatial}


def label_maps(torch, dev, gen, kind: str, classes: int = 847, maps: int = 16, side: int = 512):
    """One ADE20K-Full update's ``(preds, target, valid)`` (16 maps of 512x512), formatted as the metric does.

    ``ade20k``: the ade20k_full phase's law (10% void, 70% of the rest right,
    pixels i.i.d.); ``uniform``: i.i.d. pairs, no void; ``coherent``: each
    label constant over 16x16 patches, 70% of the patches right, as real
    segmentation maps are spatially coherent.
    """
    n = maps * side * side
    draw = lambda shape: torch.randint(0, classes, shape, generator=gen, device=dev)  # noqa: E731
    if kind == "ade20k":
        t = draw((n,))
        void = torch.rand(n, generator=gen, device=dev) < 0.10
        t[void] = -1
        right = (torch.rand(n, generator=gen, device=dev) < 0.70) & ~void
        p = torch.where(right, t, draw((n,)))
    elif kind == "uniform":
        t, p = draw((n,)), draw((n,))
    else:
        patches = (maps, side // 16, side // 16)
        tp = draw(patches)
        pp = torch.where(torch.rand(patches, generator=gen, device=dev) < 0.70, tp, draw(patches))
        t, p = (x.repeat_interleave(16, 1).repeat_interleave(16, 2).reshape(-1) for x in (tp, pp))
    valid = t != -1
    return torch.where(valid, p, 0), torch.where(valid, t, 0), valid


def phase_confmat_distributions(torch, kernel, dev, gen) -> dict:
    """B1 and the one-atomic-per-row design it replaced, at one ADE20K-Full update on three label laws.

    Both add into a state; both must equal the plain version exactly (the new
    kernel over two calls into one matrix). The old kernel's times across the
    laws show what set its pace; the new one's, how far it still depends on the data.
    """
    lib, c = kernel._library(), 847
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def row_atomics(p, t, valid, out):  # the replaced kernel's own launch: 256 threads, up to 8 blocks an SM
        n = p.numel()
        err = lib.tm_confmat_row_atomics(p.data_ptr(), t.data_ptr(), valid.data_ptr(), n, c, 1, 1, 0, out.data_ptr(),
                                         min(8 * sms, -(-n // 256)), torch.cuda.current_stream(dev).cuda_stream)
        check(err == 0, f"row-atomics baseline launch failed: {err}")

    laws = {}
    for kind in ("ade20k", "uniform", "coherent"):
        p, t, valid = label_maps(torch, dev, gen, kind, c)
        ref = kernel.confusion_matrix_plain(p, t, c, valid)
        state, old = torch.zeros_like(ref), torch.zeros_like(ref)
        for _ in range(2):
            kernel.confusion_matrix_cuda(p, t, c, valid, out=state)
        row_atomics(p, t, valid, old)
        torch.cuda.synchronize()
        check(torch.equal(state, 2 * ref), f"B1 {kind}: two calls with out= != twice the plain version")
        check(torch.equal(old, ref), f"B1 row-atomics baseline {kind} != plain version")
        laws[kind] = {
            "diagonal_share": float(ref.diagonal().sum() / ref.sum()),
            "ms": queued_ms(torch, lambda: kernel.confusion_matrix_cuda(p, t, c, valid, out=state), reps=50),
            "old_ms": queued_ms(torch, lambda: row_atomics(p, t, valid, state), reps=50),
        }
        del p, t, valid
    n = 16 * 512 * 512
    emit({"phase": "confmat_distributions", "n": n, "classes": c, "labels": "int64 + bool mask", "laws": laws,
          "bound_ms": n * 17 / HBM_BYTES_PER_S * 1e3, "check": "exact, two calls with out= and the baseline",
          "ms": "queued_ms into a state; old_ms: the one-atomic-per-row kernel"})
    return laws


def phase_confmat_exact_2p24(torch, kernel, dev) -> int:
    """2**24 + 3 rows, all (1, 1), in one update: every confusion matrix must hold exactly 16,777,219 in cell (1, 1).

    Binary and 3 classes take the integer ``bincount`` route, 300 classes
    kernel B1; a float32 count would round there. Returns B1's launches.
    """
    from torchmetrics_tpu_torch.classification import BinaryConfusionMatrix, MulticlassConfusionMatrix

    n = 2**24 + 3
    ones = torch.ones(n, dtype=torch.int64, device=dev)
    kernel.confusion_matrix_cuda.launches = 0
    cells = {}
    for name, metric in (("binary", BinaryConfusionMatrix()), ("multiclass_3", MulticlassConfusionMatrix(num_classes=3)),
                         ("multiclass_300", MulticlassConfusionMatrix(num_classes=300))):
        metric.update(ones, ones)
        cm = metric.compute()
        check(cm.device == dev and cm.dtype == torch.int32, f"{name}: {cm.device} {cm.dtype}")
        cells[name] = int(cm[1, 1])
        check(cells[name] == n == 16_777_219 and int(cm.sum()) == n, f"{name}: cell (1, 1) {cells[name]} != {n}")
    launches = kernel.confusion_matrix_cuda.launches
    check(launches == 1, f"B1 launches {launches} != 1 (the 300-class update)")
    emit({"phase": "confmat_exact_2p24", "rows": n, "cell_1_1": cells, "confmat_launches": launches,
          "check": "exact: 16,777,219 in cell (1, 1)"})
    return launches


def _host_binned_auroc(probs, target, thresholds):
    """Macro AUROC of (T, C) binned counts in float64: a score counts at a threshold it reaches (>=)."""
    import numpy as np

    n, c = probs.shape
    sorted_cols = np.sort(probs, axis=0)
    tpr, fpr = np.empty((len(thresholds), c)), np.empty((len(thresholds), c))
    for k in range(c):
        pos = np.sort(probs[target == k, k])
        above_all = n - np.searchsorted(sorted_cols[:, k], thresholds, side="left")
        tp = len(pos) - np.searchsorted(pos, thresholds, side="left")
        fp = above_all - tp
        tpr[:, k] = tp / len(pos) if len(pos) else 0.0
        fpr[:, k] = fp / (n - len(pos)) if n - len(pos) else 0.0
    tpr, fpr = tpr[::-1], fpr[::-1]  # thresholds descending: the ROC runs from (0, 0) up
    areas = ((tpr[1:] + tpr[:-1]) / 2 * np.diff(fpr, axis=0)).sum(0)
    return float(areas.mean())


def _host_rank_sum_aurocs(probs, target, first_class: int):
    """Per-class AUROC of the columns ``probs[:, j]`` (class ``first_class + j``) as the Mann-Whitney statistic:
    float64 ranks, ties averaged (``scipy.stats.rankdata``)."""
    import numpy as np
    from scipy.stats import rankdata

    ranks = rankdata(probs.astype(np.float64), axis=0)
    areas = []
    for j in range(probs.shape[1]):
        pos = target == first_class + j
        n_pos, n_neg = int(pos.sum()), int((~pos).sum())
        areas.append((ranks[pos, j].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))
    return areas


def phase_classification_collection(torch, np, kernel, dev, gen, smi: str, n_val: int = 50_000, c: int = 1000,
                                    batch: int = 1024) -> dict:
    """BASELINE config 2 on imagenet_val: a ``MetricCollection`` of accuracy, precision, recall, F1, binned and
    exact AUROC and two confusion matrices over 50,000 samples of 1000 classes, batches of 1024, half by
    ``forward``, half by ``update``. Checked against the host, the same metrics outside a collection, the
    compute groups of the CPU tests and B1's launch count. Returns the phase's numbers and B1's launches.
    """
    import torchmetrics_tpu_torch as tt

    n_thresholds = 100

    def members():
        return {
            "acc": tt.MulticlassAccuracy(num_classes=c, average="micro"),
            "precision": tt.MulticlassPrecision(num_classes=c),
            "recall": tt.MulticlassRecall(num_classes=c),
            "f1": tt.MulticlassF1Score(num_classes=c),
            "auroc_binned": tt.MulticlassAUROC(num_classes=c, thresholds=n_thresholds),
            "auroc_exact": tt.MulticlassAUROC(num_classes=c),
            "cm": tt.MulticlassConfusionMatrix(num_classes=c),
            "cm_true": tt.MulticlassConfusionMatrix(num_classes=c, normalize="true"),
        }

    logits = torch.randn((n_val, c), generator=gen, device=dev)
    target = torch.randint(0, c, (n_val,), generator=gen, device=dev)
    hit = torch.rand(n_val, generator=gen, device=dev) < 0.76
    logits[torch.arange(n_val, device=dev)[hit], target[hit]] += 10.0
    starts = list(range(0, n_val, batch))
    mc = tt.MetricCollection(members())
    check(all(m.device == dev for m in mc.values()), "a member's states are not on the card")
    # the metrics' own probabilities (the same softmax on the same batch shapes), for the host references,
    # which run in worker processes on the host's other cores while the card streams
    probs = torch.cat([torch.softmax(logits[s:s + batch], dim=1) for s in starts]).cpu().numpy()
    host_t = target.cpu().numpy()
    thresholds = mc["auroc_binned"].thresholds.cpu().numpy()
    step = -(-c // 4)  # four workers, a quarter of the classes each
    chunks = [(lo, min(lo + step, c)) for lo in range(0, c, step)]
    with ProcessPoolExecutor(max_workers=len(chunks), mp_context=multiprocessing.get_context("spawn")) as pool:
        rank_sum_parts = [pool.submit(_host_rank_sum_aurocs, probs[:, lo:hi], host_t, lo) for lo, hi in chunks]
        binned_future = pool.submit(_host_binned_auroc, probs, host_t, thresholds)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernel.confusion_matrix_cuda.launches = 0
        call_ms = {"forward": [], "update": []}
        t0 = time.perf_counter()
        for b, start in enumerate(starts):
            p, t = logits[start:start + batch], target[start:start + batch]
            t_call = time.perf_counter()
            if b % 2 == 0:
                mc(p, t)
            else:
                mc.update(p, t)
            torch.cuda.synchronize()
            call_ms["forward" if b % 2 == 0 else "update"].append((time.perf_counter() - t_call) * 1e3)
        stream_s = time.perf_counter() - t0
        launches = kernel.confusion_matrix_cuda.launches
        n_forward = len(call_ms["forward"])
        compute_ms = {}
        for name in ("auroc_binned", "auroc_exact"):
            t0 = time.perf_counter()
            mc[name].compute()
            torch.cuda.synchronize()
            compute_ms[name] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        res = mc.compute()
        torch.cuda.synchronize()
        compute_ms["collection_rest"] = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated()
        # the same metrics outside a collection, by update only: identical states, so identical results
        alone = members()
        for start in starts:
            for m in alone.values():
                m.update(logits[start:start + batch], target[start:start + batch])
        for name, m in alone.items():
            check(torch.equal(m.compute(), res[name]), f"{name}: collection result != the metric outside a collection")
        exact_ref = float(np.mean([area for part in rank_sum_parts for area in part.result()]))
        binned_ref = binned_future.result()
    n_update = len(starts) - n_forward
    expected_groups = {0: ["acc", "f1", "precision", "recall"], 1: ["auroc_binned"], 2: ["auroc_exact"],
                       3: ["cm", "cm_true"]}
    check(mc.compute_groups == expected_groups, f"compute groups {mc.compute_groups}")
    check(launches == n_update + 2 * n_forward,
          f"B1 launches {launches} != {n_update} updates (group head) + 2 x {n_forward} forwards")
    check(all(v.device == dev for v in res.values()), "a result left the card")

    # host references: counts and ratios from numpy, AUROC in float64 on the metrics' own probabilities
    pred1 = probs.argmax(1)
    cm_ref = np.bincount(host_t * c + pred1, minlength=c * c).reshape(c, c)
    check(np.array_equal(res["cm"].cpu().numpy(), cm_ref), "confusion matrix != host bincount")
    tp = np.diag(cm_ref).astype(np.float64)
    fp, fn = cm_ref.sum(0) - tp, cm_ref.sum(1) - tp
    head = mc._modules["acc"]
    for state, want in (("tp", tp), ("fp", fp), ("fn", fn)):
        check(np.array_equal(getattr(head, state).cpu().numpy(), want), f"stat-scores {state} != host")
    check(float(res["acc"]) == float(np.float32(tp.sum()) / np.float32(n_val)), "micro accuracy != host")
    present = (tp + fp + fn) > 0
    with np.errstate(invalid="ignore", divide="ignore"):
        macro = {
            "precision": np.where(tp + fp > 0, tp / (tp + fp), 0.0),
            "recall": np.where(tp + fn > 0, tp / (tp + fn), 0.0),
            "f1": np.where(2 * tp + fp + fn > 0, 2 * tp / (2 * tp + fp + fn), 0.0),
        }
    ratio_err = 0.0
    for name, per_class in macro.items():
        err = abs(float(res[name]) - float(per_class[present].mean()))
        ratio_err = max(ratio_err, err)
        check(err <= COLLECTION_RATIO_ATOL, f"macro {name} {float(res[name])} vs host: {err}")
    row_sums = cm_ref.sum(1, keepdims=True)
    cm_true_ref = np.where(row_sums > 0, cm_ref / np.maximum(row_sums, 1), 0.0)
    cm_true_err = float(np.abs(res["cm_true"].cpu().numpy() - cm_true_ref).max())
    check(cm_true_err <= COLLECTION_RATIO_ATOL, f"normalized confusion matrix vs host: {cm_true_err}")
    binned_err = abs(float(res["auroc_binned"]) - binned_ref)
    check(binned_err <= BINNED_AUROC_ATOL, f"binned AUROC vs numpy: {binned_err}")
    exact_err = abs(float(res["auroc_exact"]) - exact_ref)
    check(exact_err <= EXACT_AUROC_ATOL, f"exact AUROC vs rank sum: {exact_err}")

    # one binned update's temporaries: the (N, C, T) compares and their int64 sums
    p, t = logits[:batch], target[:batch]
    binned_only = tt.MulticlassAUROC(num_classes=c, thresholds=n_thresholds)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    binned_only.update(p, t)
    torch.cuda.synchronize()
    binned_update_peak = torch.cuda.max_memory_allocated() - base
    state = torch.zeros((c, c), dtype=torch.int32, device=dev)
    out = {
        "phase": "classification_collection", "samples": n_val, "classes": c, "batch": batch,
        "batches": len(starts), "forward_batches": n_forward, "update_batches": n_update,
        "compute_groups": mc.compute_groups, "confmat_launches": launches,
        "results": {k: float(v) for k, v in res.items() if v.numel() == 1},
        "max_err": {"macro_ratios": ratio_err, "cm_true": cm_true_err, "auroc_binned": binned_err,
                    "auroc_exact": exact_err},
        "tolerance": {"counts": "exact", "micro_accuracy": "exact", "macro_ratios": COLLECTION_RATIO_ATOL,
                      "auroc_binned_vs_numpy": BINNED_AUROC_ATOL, "auroc_exact_vs_rank_sum": EXACT_AUROC_ATOL},
        "seconds": stream_s, "batches_per_s": len(starts) / stream_s, "samples_per_s": n_val / stream_s,
        "update_ms": statistics.median(call_ms["update"]), "forward_ms": statistics.median(call_ms["forward"]),
        "first_call_ms": call_ms["forward"][0], "compute_ms": compute_ms,
        "peak_mem_bytes": peak, "binned_auroc_update_peak_bytes": binned_update_peak,
        # what a copy of one member's 4 MB (1000, 1000) int32 state would cost, were group states copied
        "state_clone_ms_4mb": median_ms(torch, lambda: state.clone(), reps=50),
        "card": smi,
    }
    emit(out)
    return out


def phase_aggregation(torch, np, dev, gen) -> None:
    """Mean, Sum, Max, Cat and RunningMean(window=5) over 49 batches of 16 per-sample losses made on the card,
    one batch with NaNs, under ``nan_strategy="ignore"``; each within ``AGG_RTOL`` of float64 on the host."""
    import torchmetrics_tpu_torch as tt

    losses = torch.rand((49, 16), generator=gen, device=dev) * 3.0 + 0.05
    losses[7, ::5] = float("nan")
    metrics = {
        "mean": tt.MeanMetric(nan_strategy="ignore"), "sum": tt.SumMetric(nan_strategy="ignore"),
        "max": tt.MaxMetric(nan_strategy="ignore"), "cat": tt.CatMetric(nan_strategy="ignore"),
        "running_mean": tt.RunningMean(window=5, nan_strategy="ignore"),
    }
    for b in range(losses.shape[0]):
        for name, m in metrics.items():
            m(losses[b]) if b % 2 == 0 else m.update(losses[b])
    got = {name: m.compute() for name, m in metrics.items()}
    check(all(v.device == dev for v in got.values()), "an aggregate left the card")
    host = losses.cpu().numpy().astype(np.float64)
    kept = host[~np.isnan(host)]
    window = host[-5:][~np.isnan(host[-5:])]
    want = {"mean": kept.mean(), "sum": kept.sum(), "max": kept.max(), "running_mean": window.mean()}
    errs = {name: abs(float(got[name]) - w) / abs(w) for name, w in want.items()}
    cat = got["cat"].cpu().numpy().astype(np.float64)
    errs["cat"] = float(np.abs(cat - kept).max() / np.abs(kept).max()) if cat.shape == kept.shape else float("inf")
    for name, err in errs.items():
        check(err <= AGG_RTOL, f"{name}: relative error {err} > {AGG_RTOL}")
    emit({"phase": "aggregation", "batches": losses.shape[0], "values": int(kept.size), "nan_values": int(np.isnan(host).sum()),
          "results": {k: float(v) for k, v in got.items() if v.numel() == 1}, "max_rel_err": errs, "rtol": AGG_RTOL})


# ---------------------------------------------------------------------------------------------------------------
# the rest of classification: MCC, kappa and Jaccard on B1, specificity, Hamming, exact match, average precision,
# the operating points, calibration, hinge, ranking, Dice and fairness; each against float64 numpy on the host


def _host_confmat_scores(cm) -> dict:
    """float64 MCC, Cohen's kappa (no weights), per-class IoU and macro IoU (absent classes dropped) of a
    confusion matrix, and the per-class macro specificity and Hamming distance of its stat scores."""
    import numpy as np

    cm = cm.astype(np.float64)
    tp, rows, cols = np.diag(cm), cm.sum(1), cm.sum(0)
    s, c = cm.sum(), tp.sum()
    den = (s * s - cols @ cols) * (s * s - rows @ rows)
    kappa_w = 1.0 - np.eye(cm.shape[0])
    union = rows + cols - tp
    fp, fn = cols - tp, rows - tp
    tn = s - tp - fp - fn
    present = tp + fp + fn > 0
    with np.errstate(invalid="ignore", divide="ignore"):
        iou = np.where(union > 0, tp / union, 0.0)
        specificity = np.where(tn + fp > 0, tn / (tn + fp), 0.0)
        hamming = 1.0 - np.where(tp + fn > 0, tp / (tp + fn), 0.0)
    return {
        "mcc": (c * s - rows @ cols) / np.sqrt(den) if den > 0 else 0.0,
        "kappa": 1.0 - (kappa_w * cm).sum() / (kappa_w * np.outer(rows, cols) / s).sum(),
        "iou": iou, "miou": iou[union > 0].mean(),
        "specificity": specificity[present].mean(), "hamming": hamming[present].mean(),
    }


def _host_operating_point(value, other, mask, thresholds):
    """Max ``value`` where ``mask``, ties to the max ``other``, the first such threshold; 0 and 1e6 where none."""
    import numpy as np

    if not mask.any():
        return 0.0, 1e6
    best = value[mask].max()
    tie = mask & (value == best)
    idx = int(np.argmax(tie & (other == other[tie].max())))
    return float(best), (1e6 if best == 0 else float(thresholds[idx]))


def _host_class_curves(scores, positives, thresholds, op: str) -> dict:
    """Per column of ``scores`` (the card's float32 probabilities) against ``positives``, in float64.

    ``ap_exact``: a stable descending sort and cumulative sums, each distinct score one point, as the
    reference's exact curve. On the binned ``thresholds`` (a score counts at a threshold it reaches):
    ``ap_binned``; ``op`` at 0.5, recall at fixed precision (``"rfp"``) or precision at fixed recall
    (``"pfr"``), with its threshold; and specificity at sensitivity 0.5 with its threshold, read from the ROC
    in descending thresholds.
    """
    import numpy as np

    n, k = scores.shape
    out = {name: np.empty(k) for name in ("ap_exact", "ap_binned", "op", "op_thr", "sas", "sas_thr")}
    for j in range(k):
        s, y = scores[:, j], positives[:, j]
        order = np.argsort(-s, kind="stable")
        idx = np.r_[np.nonzero(np.diff(s[order]))[0], n - 1]
        tps = np.cumsum(y[order])[idx].astype(np.float64)
        fps = 1 + idx - tps
        prec = np.r_[(tps / (tps + fps))[::-1], 1.0]
        rec = np.r_[(tps / tps[-1])[::-1], 0.0]
        out["ap_exact"][j] = -np.sum((rec[1:] - rec[:-1]) * prec[:-1])
        n_pos = int(y.sum())
        tp = (n_pos - np.searchsorted(np.sort(s[y]), thresholds, side="left")).astype(np.float64)
        fp = n - np.searchsorted(np.sort(s), thresholds, side="left") - tp
        fn, tn = n_pos - tp, (n - n_pos) - fp
        p = np.where(tp + fp > 0, tp / np.maximum(tp + fp, 1), 0.0)
        r = np.where(tp + fn > 0, tp / np.maximum(tp + fn, 1), 0.0)
        big_p, big_r = np.r_[p, 1.0], np.r_[r, 0.0]
        out["ap_binned"][j] = -np.sum((big_r[1:] - big_r[:-1]) * big_p[:-1])
        if op == "rfp":
            out["op"][j], out["op_thr"][j] = _host_operating_point(r, p, p >= 0.5, thresholds)
        else:
            out["op"][j], out["op_thr"][j] = _host_operating_point(p, r, r >= 0.5, thresholds)
        spec = 1.0 - np.where(fp + tn > 0, fp / np.maximum(fp + tn, 1), 0.0)[::-1]
        sens = r[::-1]
        mask = sens >= 0.5
        if mask.any():
            out["sas"][j] = spec[mask].max()
            out["sas_thr"][j] = thresholds[::-1][int(np.argmax(mask & (spec == out["sas"][j])))]
        else:
            out["sas"][j], out["sas_thr"][j] = 0.0, 1e6
    return out


def _host_ranking(probs, target) -> dict:
    """Label-ranking AP, ranking loss and coverage error in float64, tied scores at their average rank."""
    import numpy as np

    n, labels = probs.shape
    sums = {"ranking_ap": 0.0, "ranking_loss": 0.0, "coverage": 0.0}
    for lo in range(0, n, 2048):
        s, rel = probs[lo:lo + 2048].astype(np.float64), target[lo:lo + 2048] == 1
        gt = s[:, None, :] > s[:, :, None]  # [b, j, m]: label m scored above label j
        eq = s[:, None, :] == s[:, :, None]
        rank_all = gt.sum(-1) + (eq.sum(-1) + 1) / 2
        rank_rel = (gt & rel[:, None, :]).sum(-1) + ((eq & rel[:, None, :]).sum(-1) + 1) / 2
        n_rel = rel.sum(1)
        ratio = np.where(rel, rank_rel / rank_all, 0.0).sum(1)
        sums["ranking_ap"] += np.where((n_rel > 0) & (n_rel < labels), ratio / np.maximum(n_rel, 1), 1.0).sum()
        miss = ((gt | eq) & rel[:, :, None] & ~rel[:, None, :]).sum((1, 2))
        denom = n_rel * (labels - n_rel)
        sums["ranking_loss"] += np.where(denom > 0, miss / np.maximum(denom, 1), 0.0).sum()
        min_rel = np.where(rel, s, np.inf).min(1)
        sums["coverage"] += np.where(n_rel > 0, (s >= min_rel[:, None]).sum(1), 0).sum()
    return {k: v / n for k, v in sums.items()}


def _host_calibration(probs, target, boundaries) -> dict:
    """Top-1 ECE (l1) and MCE (max) in float64 over the float32 ``boundaries``, right-closed as searchsorted(right)."""
    import numpy as np

    conf, hit = probs.max(1), (probs.argmax(1) == target).astype(np.float64)
    n_bins = len(boundaries) - 1
    idx = np.clip(np.searchsorted(boundaries[1:-1], conf, side="right"), 0, n_bins - 1)
    counts = np.bincount(idx, minlength=n_bins).astype(np.float64)
    safe = np.maximum(counts, 1)
    gap = np.abs(np.bincount(idx, weights=hit, minlength=n_bins) / safe
                 - np.bincount(idx, weights=conf.astype(np.float64), minlength=n_bins) / safe)
    return {"l1": float((gap * counts / len(conf)).sum()), "max": float(gap.max())}


def _launches_per_update(torch, kernel, mc, batches) -> list:
    """Stream ``batches`` through ``mc.update``; B1's launches in each update (its count is reset first)."""
    per_update = []
    kernel.confusion_matrix_cuda.launches = 0
    for args in batches:
        before = kernel.confusion_matrix_cuda.launches
        mc.update(*args)
        per_update.append(kernel.confusion_matrix_cuda.launches - before)
    torch.cuda.synchronize()
    return per_update


def _groups(mc) -> set:
    return {frozenset(g) for g in mc.compute_groups.values()}


def _compute_ms(torch, mc, names) -> dict:
    """Each member's own ``compute``, on the host clock after a device synchronize."""
    out = {}
    for name in names:
        t0 = time.perf_counter()
        mc[name].compute()
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t0) * 1e3
    return out


def phase_ade20k_miou(torch, np, kernel, dev, seg_preds, seg_target, ade_cm, smi: str) -> int:
    """Mean IoU on ADE20K-Full: the ade20k_full maps (847 classes, 8 updates of 16 maps of 512x512, 10% void under
    ``ignore_index=-1``) through one ``MetricCollection`` of the confusion matrix, macro and per-class Jaccard, MCC and
    kappa. One compute group; B1 once an update once the group is known (the first update runs every member, to
    find the groups). Values against float64 numpy from the exact matrix, and equal to each metric run alone.
    Returns B1's launches.
    """
    import torchmetrics_tpu_torch as tt

    c = 847

    def members():
        return {
            "cm": tt.MulticlassConfusionMatrix(num_classes=c, ignore_index=-1),
            "miou": tt.MulticlassJaccardIndex(num_classes=c, average="macro", ignore_index=-1),
            "iou": tt.MulticlassJaccardIndex(num_classes=c, average="none", ignore_index=-1),
            "mcc": tt.MulticlassMatthewsCorrCoef(num_classes=c, ignore_index=-1),
            "kappa": tt.MulticlassCohenKappa(num_classes=c, ignore_index=-1),
        }

    mc = tt.MetricCollection(members())
    updates = [(seg_preds[u], seg_target[u]) for u in range(seg_preds.shape[0])]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    per_update = _launches_per_update(torch, kernel, mc, updates)
    stream_s = time.perf_counter() - t0
    res = mc.compute()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launches = sum(per_update)
    check(_groups(mc) == {frozenset(members())}, f"compute groups {mc.compute_groups}")
    check(per_update == [len(members())] + [1] * (len(updates) - 1),
          f"B1 launches per update {per_update}: every member once on the first update, then the group head once")
    check(torch.equal(res["cm"], ade_cm), "the collection's confusion matrix != the ade20k_full one")

    host = _host_confmat_scores(ade_cm.cpu().numpy())
    errs = {
        "miou": abs(float(res["miou"]) - host["miou"]),
        "iou": float(np.abs(res["iou"].cpu().numpy().astype(np.float64) - host["iou"]).max()),
        "mcc": abs(float(res["mcc"]) - host["mcc"]) / abs(host["mcc"]),
        "kappa": abs(float(res["kappa"]) - host["kappa"]) / abs(host["kappa"]),
    }
    check(errs["miou"] <= SLICE6_ATOL and errs["iou"] <= SLICE6_ATOL, f"IoU vs float64: {errs}")
    check(errs["mcc"] <= MCC_KAPPA_RTOL and errs["kappa"] <= MCC_KAPPA_RTOL, f"MCC/kappa vs float64: {errs}")
    alone = members()
    for args in updates:
        for m in alone.values():
            m.update(*args)
    for name, m in alone.items():
        check(torch.equal(m.compute(), res[name]), f"{name}: collection result != the metric outside a collection")
    emit({
        "phase": "ade20k_miou", "classes": c, "updates": len(updates), "pixels": int(ade_cm.sum()),
        "compute_groups": mc.compute_groups, "confmat_launches": launches, "launches_per_update": per_update,
        "miou": float(res["miou"]), "mcc": float(res["mcc"]), "kappa": float(res["kappa"]),
        "host_float64": {"miou": host["miou"], "mcc": host["mcc"], "kappa": host["kappa"]},
        "err": errs, "tolerance": {"iou_abs": SLICE6_ATOL, "mcc_kappa_rel": MCC_KAPPA_RTOL},
        "seconds": stream_s, "updates_per_s": len(updates) / stream_s, "peak_mem_bytes": peak, "card": smi,
    })
    return launches


def phase_classification_rest(torch, np, kernel, dev, logits, target, smi: str, batch: int = 1024) -> int:
    """The rest of classification on the imagenet_val data (50,000 x 1000, batches of 1024) in one
    ``MetricCollection``: MCC, kappa and Jaccard (one confusion-matrix group, B1), specificity and Hamming (one
    stat-scores group), average precision binned at 100 thresholds and exact, recall at precision 0.5 and
    specificity at sensitivity 0.5 (binned, one group with the binned AP), ECE and MCE (15 bins) and the
    Crammer-Singer hinge loss. Each against float64 numpy on the host, the curves computed in worker processes
    while the card streams. Returns B1's launches.
    """
    import torchmetrics_tpu_torch as tt
    from torchmetrics_tpu_torch.functional.classification.calibration_error import _bin_boundaries

    n, c = logits.shape
    mc = tt.MetricCollection({
        "mcc": tt.MulticlassMatthewsCorrCoef(num_classes=c),
        "kappa": tt.MulticlassCohenKappa(num_classes=c),
        "jaccard": tt.MulticlassJaccardIndex(num_classes=c),
        "specificity": tt.MulticlassSpecificity(num_classes=c),
        "hamming": tt.MulticlassHammingDistance(num_classes=c),
        "ap_binned": tt.MulticlassAveragePrecision(num_classes=c, thresholds=100),
        "ap_exact": tt.MulticlassAveragePrecision(num_classes=c),
        "recall_at_precision": tt.MulticlassRecallAtFixedPrecision(num_classes=c, min_precision=0.5, thresholds=100),
        "specificity_at_sensitivity": tt.MulticlassSpecificityAtSensitivity(num_classes=c, min_sensitivity=0.5,
                                                                              thresholds=100),
        "ece": tt.MulticlassCalibrationError(num_classes=c, n_bins=15, norm="l1"),
        "mce": tt.MulticlassCalibrationError(num_classes=c, n_bins=15, norm="max"),
        "hinge": tt.MulticlassHingeLoss(num_classes=c),
    })
    starts = list(range(0, n, batch))
    probs = torch.cat([torch.softmax(logits[s:s + batch], dim=1) for s in starts]).cpu().numpy()
    host_t = target.cpu().numpy()
    thresholds = mc["ap_binned"].thresholds.cpu().numpy()
    step = -(-c // 4)
    chunks = [(lo, min(lo + step, c)) for lo in range(0, c, step)]
    with ProcessPoolExecutor(max_workers=len(chunks), mp_context=multiprocessing.get_context("spawn")) as pool:
        parts = [pool.submit(_host_class_curves, probs[:, lo:hi], host_t[:, None] == np.arange(lo, hi)[None],
                             thresholds, "rfp") for lo, hi in chunks]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        per_update = _launches_per_update(torch, kernel, mc, [(logits[s:s + batch], target[s:s + batch])
                                                              for s in starts])
        stream_s = time.perf_counter() - t0
        compute_ms = _compute_ms(torch, mc, list(mc.keys()))
        res = mc.compute()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        curves = {key: np.concatenate([p.result()[key] for p in parts]) for key in parts[0].result()}
    launches = sum(per_update)
    want_groups = {frozenset({"mcc", "kappa", "jaccard"}), frozenset({"specificity", "hamming"}),
                   frozenset({"ap_binned", "recall_at_precision", "specificity_at_sensitivity"}),
                   frozenset({"ap_exact"}), frozenset({"ece", "mce"}), frozenset({"hinge"})}
    check(_groups(mc) == want_groups, f"compute groups {mc.compute_groups}")
    check(per_update == [3] + [1] * (len(starts) - 1),
          f"B1 launches per update {per_update}: 3 members on the first update, then the group head once")

    cm = np.bincount(host_t * c + logits.argmax(1).cpu().numpy(), minlength=c * c).reshape(c, c)
    check(np.array_equal(mc._modules["mcc"].confmat.cpu().numpy(), cm), "confusion matrix != host bincount")
    scores = _host_confmat_scores(cm)
    calib = _host_calibration(probs, host_t, _bin_boundaries(15).numpy())
    p_true = probs[np.arange(n), host_t].astype(np.float64)
    others = probs.copy()
    others[np.arange(n), host_t] = -np.inf
    hinge = np.clip(1.0 - (p_true - others.max(1)), 0.0, None).mean()
    errs = {name: abs(float(res[name]) - scores[key]) for name, key in
            (("mcc", "mcc"), ("kappa", "kappa"), ("jaccard", "miou"), ("specificity", "specificity"),
             ("hamming", "hamming"))}
    errs["ap_binned"] = abs(float(res["ap_binned"]) - curves["ap_binned"].mean())
    errs["ap_exact"] = abs(float(res["ap_exact"]) - np.nanmean(curves["ap_exact"]))
    rap, rap_thr = (x.cpu().numpy() for x in res["recall_at_precision"])
    sas, sas_thr = (x.cpu().numpy() for x in res["specificity_at_sensitivity"])
    errs["recall_at_precision"] = float(np.abs(rap - curves["op"]).max())
    errs["specificity_at_sensitivity"] = float(np.abs(sas - curves["sas"]).max())
    errs["ece"] = abs(float(res["ece"]) - calib["l1"])
    errs["mce"] = abs(float(res["mce"]) - calib["max"])
    errs["hinge"] = abs(float(res["hinge"]) - hinge) / hinge
    tolerance = {name: SLICE6_ATOL for name in errs}
    tolerance.update({"ap_exact": EXACT_AP_ATOL, "ece": CALIBRATION_ATOL, "mce": CALIBRATION_ATOL,
                      "hinge": SUM_RTOL})
    for name, err in errs.items():
        check(err <= tolerance[name], f"{name} vs float64 numpy: {err} > {tolerance[name]}")
    check(np.array_equal(rap_thr, curves["op_thr"].astype(np.float32)), "recall@precision thresholds != host")
    check(np.array_equal(sas_thr, curves["sas_thr"].astype(np.float32)), "specificity@sensitivity thresholds != host")
    emit({
        "phase": "classification_rest", "samples": n, "classes": c, "batch": batch, "batches": len(starts),
        "compute_groups": mc.compute_groups, "confmat_launches": launches, "launches_per_update": per_update[:3],
        "results": {k: float(v) for k, v in res.items() if isinstance(v, torch.Tensor) and v.numel() == 1},
        "err": errs, "tolerance": tolerance, "thresholds": "exact",
        "seconds": stream_s, "batches_per_s": len(starts) / stream_s, "samples_per_s": n / stream_s,
        "compute_ms": compute_ms, "peak_mem_bytes": peak, "card": smi,
    })
    return launches


def phase_coco_multilabel(torch, np, dev, gen, smi: str, n_img: int = 40_504, labels: int = 80,
                          batch: int = 256) -> None:
    """MS-COCO 2014's multilabel evaluation shape (val2014: 40,504 images, 80 labels, ~2.9 positive an image; logits
    made from the seed, positives shifted up) in batches of 256, through one ``MetricCollection``: average precision
    exact and binned, precision at recall 0.5, the three ranking metrics, exact match, Hamming, Jaccard, MCC and
    specificity. Against float64 numpy on the host, computed in worker processes while the card streams."""
    import torchmetrics_tpu_torch as tt

    target = (torch.rand((n_img, labels), generator=gen, device=dev) < 2.9 / labels).to(torch.int64)
    logits = torch.randn((n_img, labels), generator=gen, device=dev) + 4.0 * target - 2.0
    mc = tt.MetricCollection({
        "ap_exact": tt.MultilabelAveragePrecision(num_labels=labels),
        "ap_binned": tt.MultilabelAveragePrecision(num_labels=labels, thresholds=100),
        "precision_at_recall": tt.MultilabelPrecisionAtFixedRecall(num_labels=labels, min_recall=0.5, thresholds=100),
        "ranking_ap": tt.MultilabelRankingAveragePrecision(num_labels=labels),
        "ranking_loss": tt.MultilabelRankingLoss(num_labels=labels),
        "coverage": tt.MultilabelCoverageError(num_labels=labels),
        "exact_match": tt.MultilabelExactMatch(num_labels=labels),
        "hamming": tt.MultilabelHammingDistance(num_labels=labels),
        "jaccard": tt.MultilabelJaccardIndex(num_labels=labels),
        "mcc": tt.MultilabelMatthewsCorrCoef(num_labels=labels),
        "specificity": tt.MultilabelSpecificity(num_labels=labels),
    })
    starts = list(range(0, n_img, batch))
    probs = torch.cat([torch.sigmoid(logits[s:s + batch]) for s in starts]).cpu().numpy()
    host_t = target.cpu().numpy()
    thresholds = mc["ap_binned"].thresholds.cpu().numpy()
    with ProcessPoolExecutor(max_workers=4, mp_context=multiprocessing.get_context("spawn")) as pool:
        parts = [pool.submit(_host_class_curves, probs[:, lo:lo + 20], host_t[:, lo:lo + 20] == 1, thresholds, "pfr")
                 for lo in range(0, labels, 20)]
        ranking = pool.submit(_host_ranking, probs, host_t)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for s in starts:
            mc.update(logits[s:s + batch], target[s:s + batch])
        torch.cuda.synchronize()
        stream_s = time.perf_counter() - t0
        compute_ms = _compute_ms(torch, mc, list(mc.keys()))
        res = mc.compute()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        curves = {key: np.concatenate([p.result()[key] for p in parts]) for key in parts[0].result()}
        rank = ranking.result()
    want_groups = {frozenset({"ap_binned", "precision_at_recall"}), frozenset({"hamming", "specificity"}),
                   frozenset({"jaccard", "mcc"}), frozenset({"ap_exact"}), frozenset({"ranking_ap"}),
                   frozenset({"ranking_loss"}), frozenset({"coverage"}), frozenset({"exact_match"})}
    check(_groups(mc) == want_groups, f"compute groups {mc.compute_groups}")

    pred = probs > 0.5
    pos = host_t == 1
    tp, fp = (pred & pos).sum(0).astype(np.float64), (pred & ~pos).sum(0).astype(np.float64)
    fn, tn = (~pred & pos).sum(0).astype(np.float64), (~pred & ~pos).sum(0).astype(np.float64)
    states = mc._modules["hamming"]
    for name, want in (("tp", tp), ("fp", fp), ("tn", tn), ("fn", fn)):
        check(np.array_equal(getattr(states, name).cpu().numpy(), want), f"multilabel stat scores {name} != host")
    t_all, p_all, n_all, f_all = tp.sum(), fp.sum(), tn.sum(), fn.sum()
    mcc = (t_all * n_all - p_all * f_all) / np.sqrt((t_all + p_all) * (t_all + f_all) * (n_all + p_all) * (n_all + f_all))
    want = {
        "ap_exact": np.nanmean(curves["ap_exact"]), "ap_binned": curves["ap_binned"].mean(),
        "exact_match": (pred == pos).all(1).mean(), "hamming": (1.0 - (tp + tn) / (tp + tn + fp + fn)).mean(),
        "jaccard": (tp / (tp + fp + fn)).mean(), "mcc": mcc, "specificity": (tn / (tn + fp)).mean(), **rank,
    }
    errs = {name: abs(float(res[name]) - w) for name, w in want.items()}
    for name in ("ranking_ap", "ranking_loss", "coverage"):
        errs[name] /= abs(want[name])
    par, par_thr = (x.cpu().numpy() for x in res["precision_at_recall"])
    errs["precision_at_recall"] = float(np.abs(par - curves["op"]).max())
    tolerance = {name: SLICE6_ATOL for name in errs}
    tolerance.update({"ap_exact": EXACT_AP_ATOL, "ranking_ap": SUM_RTOL, "ranking_loss": SUM_RTOL,
                      "coverage": SUM_RTOL})
    for name, err in errs.items():
        check(err <= tolerance[name], f"coco {name} vs float64 numpy: {err} > {tolerance[name]}")
    check(np.array_equal(par_thr, curves["op_thr"].astype(np.float32)), "precision@recall thresholds != host")
    emit({
        "phase": "coco_multilabel", "images": n_img, "labels": labels, "batch": batch, "batches": len(starts),
        "positives_per_image": float(pos.sum() / n_img), "compute_groups": mc.compute_groups,
        "results": {k: float(v) for k, v in res.items() if isinstance(v, torch.Tensor) and v.numel() == 1},
        "err": errs, "tolerance": tolerance, "seconds": stream_s, "images_per_s": n_img / stream_s,
        "compute_ms": compute_ms, "peak_mem_bytes": peak, "card": smi,
    })


def phase_dice_fairness(torch, np, dev, gen, smi: str, maps: int = 8, side: int = 512, n: int = 19_962) -> None:
    """Dice (150 classes, macro, mdmc global) on SceneParse150-shaped maps, 4 updates of 8 maps of 512x512: its
    stat scores exactly against numpy counts, the score within ``SLICE6_ATOL``, and the peak memory of one update's
    one-hot temporaries. ``BinaryFairness`` and ``BinaryGroupStatRates`` on CelebA's test split shape (19,962
    samples) with 2 and 4 groups: per-group counts exact, rates and ratios within ``SLICE6_ATOL``."""
    import torchmetrics_tpu_torch as tt

    c, n_updates = 150, 4
    shape = (n_updates, maps, side, side)
    target = torch.randint(0, c, shape, generator=gen, device=dev)
    preds = torch.where(torch.rand(shape, generator=gen, device=dev) < 0.6, target,
                        torch.randint(0, c, shape, generator=gen, device=dev))
    dice = tt.Dice(num_classes=c, average="macro", mdmc_average="global")
    update_peaks = []
    t0 = time.perf_counter()
    for u in range(n_updates):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        dice.update(preds[u], target[u])
        torch.cuda.synchronize()
        update_peaks.append(torch.cuda.max_memory_allocated() - base)
    value = float(dice.compute())
    dice_s = time.perf_counter() - t0
    hp, ht = preds.cpu().numpy().reshape(-1), target.cpu().numpy().reshape(-1)
    tp = np.bincount(ht[hp == ht], minlength=c)
    fp, fn = np.bincount(hp, minlength=c) - tp, np.bincount(ht, minlength=c) - tp
    for name, want in (("tp", tp), ("fp", fp), ("fn", fn)):
        check(np.array_equal(getattr(dice, name).cpu().numpy(), want), f"Dice {name} != numpy counts")
    present = tp + fp + fn > 0
    dice_ref = (2 * tp / np.maximum(2 * tp + fp + fn, 1))[present].mean()
    dice_err = abs(value - dice_ref)
    check(dice_err <= SLICE6_ATOL, f"Dice vs float64: {dice_err}")

    fairness = {}  # n: CelebA's test split
    for groups in (2, 4):
        scores = torch.rand(n, generator=gen, device=dev)
        labels = (torch.rand(n, generator=gen, device=dev) < 0.45).to(torch.int64)
        group_ids = torch.randint(0, groups, (n,), generator=gen, device=dev)
        fair, rates = tt.BinaryFairness(num_groups=groups), tt.BinaryGroupStatRates(num_groups=groups)
        for lo in range(0, n, 4096):
            args = (scores[lo:lo + 4096], labels[lo:lo + 4096], group_ids[lo:lo + 4096])
            fair.update(*args)
            rates.update(*args)
        got_fair, got_rates = fair.compute(), rates.compute()
        hs, hl, hg = scores.cpu().numpy() > 0.5, labels.cpu().numpy() == 1, group_ids.cpu().numpy()
        counts = {name: np.array([(m & (hg == g)).sum() for g in range(groups)]) for name, m in
                  (("tp", hs & hl), ("fp", hs & ~hl), ("tn", ~hs & ~hl), ("fn", ~hs & hl))}
        for name, want in counts.items():
            check(np.array_equal(getattr(fair, name).cpu().numpy(), want), f"fairness {name} != numpy ({groups} groups)")
        pos_rate = (counts["tp"] + counts["fp"]) / (counts["tp"] + counts["fp"] + counts["tn"] + counts["fn"])
        tpr = counts["tp"] / (counts["tp"] + counts["fn"])
        want = {f"DP_{pos_rate.argmin()}_{pos_rate.argmax()}": pos_rate.min() / pos_rate.max(),
                f"EO_{tpr.argmin()}_{tpr.argmax()}": tpr.min() / tpr.max()}
        check(sorted(got_fair) == sorted(want), f"fairness keys {sorted(got_fair)} != {sorted(want)}")
        err = max(abs(float(got_fair[k]) - w) for k, w in want.items())
        stats = np.stack([counts[k] for k in ("tp", "fp", "tn", "fn")], 1)
        rate_ref = stats / stats.sum(1, keepdims=True)
        err = max(err, max(float(np.abs(got_rates[f"group_{g}"].cpu().numpy() - rate_ref[g]).max())
                           for g in range(groups)))
        check(err <= SLICE6_ATOL, f"fairness vs float64 ({groups} groups): {err}")
        fairness[groups] = {"results": {k: float(v) for k, v in got_fair.items()}, "max_err": err}
    emit({
        "phase": "dice_fairness", "dice": {"classes": c, "updates": n_updates, "pixels": int(hp.size), "value": value,
                                           "err": dice_err, "seconds": dice_s,
                                           "onehot_update_peak_bytes": max(update_peaks)},
        "fairness": {"samples": n, "by_groups": fairness}, "tolerance": {"counts": "exact", "values": SLICE6_ATOL},
        "card": smi,
    })


def lpips_tap_shapes(torch, dev, net_type: str, pairs: int, side: int) -> list:
    """``(B, H, W, C)`` of each LPIPS tap's half for ``pairs`` image pairs of ``side`` x ``side``."""
    from torchmetrics_tpu_torch.image._inception import init_weights_
    from torchmetrics_tpu_torch.image._lpips import LPIPSNet
    from torchmetrics_tpu_torch.utilities.convert import build_on_cpu

    trunk = init_weights_(build_on_cpu(LPIPSNet, net_type=net_type, dtype=torch.bfloat16), 0).net
    trunk = trunk.to(device=dev, memory_format=torch.channels_last)
    x = torch.zeros((2 * pairs, 3, side, side), device=dev).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        return [(pairs, f.shape[2], f.shape[3], f.shape[1]) for f in trunk(x)]


def phase_lpips_head_vs_plain(torch, lh, tap_shapes: dict, dev, gen) -> dict:
    """B3 at every tap shape, on float32 and on bf16 maps (the trunk's dtype), against its plain version;
    two calls on the same inputs must give the same bits (one cluster a row, fixed-order sums).

    ``"odd"`` shapes (C not a multiple of a 16-byte vector) and ``"misaligned"``
    ones (maps one element past a 16-byte boundary) take the kernel's
    element-wise loads.
    """
    cases, worst_rel, worst_abs = 0, 0.0, 0.0
    for net_type, shapes in tap_shapes.items():
        for shape in shapes:
            f0 = torch.randn(shape, generator=gen, device=dev).relu_()
            f1 = (f0 + 0.3 * torch.randn(shape, generator=gen, device=dev)).relu_()
            w = torch.rand(shape[-1], generator=gen, device=dev)
            for dtype in (torch.float32, torch.bfloat16):
                a, b = f0.to(dtype), f1.to(dtype)
                if net_type == "misaligned":
                    a, b = (torch.empty(x.numel() + 1, dtype=dtype, device=dev)[1:].view(shape).copy_(x) for x in (a, b))
                got = lh.lpips_head(a, b, w)
                again = lh.lpips_head(a, b, w)
                ref = lh.lpips_head_plain(a, b, w)
                torch.cuda.synchronize()
                err = (got - ref).abs()
                rel = float((err / ref.abs()).max())
                name = f"B3 {net_type} {shape} {str(dtype).split('.')[-1]}"
                check(bool((err <= HEAD_RTOL * ref.abs() + 1e-7).all()), f"{name}: max rel err {rel}")
                check(torch.equal(got, again), f"{name}: two calls differ in their bits")
                worst_rel, worst_abs = max(worst_rel, rel), max(worst_abs, float(err.max()))
                cases += 1
                del a, b
            del f0, f1
    emit({
        "phase": "lpips_head_vs_plain", "cases": cases, "dtypes": ["float32", "bfloat16"], "max_rel_err": worst_rel,
        "max_abs_err": worst_abs, "bit_identical_repeats": cases,
        "tolerance": f"|err| <= {HEAD_RTOL} * |ref| + 1e-7 (the JAX package's rtol); repeats: identical bits",
    })
    return {"max_rel_err": worst_rel, "max_abs_err": worst_abs}


def host_fid(np, states: dict) -> dict:
    """FID in float64 on the host from a FID metric's six states (numpy ``eigh``, the metric's formula)."""
    def gaussian(prefix):
        n = float(states[f"{prefix}_features_num_samples"])
        mu = states[f"{prefix}_features_sum"] / n
        cov = (states[f"{prefix}_features_cov_sum"] - n * np.outer(mu, mu)) / (n - 1)
        return mu, cov

    mu1, s1 = gaussian("real")
    mu2, s2 = gaussian("fake")
    w1, v1 = np.linalg.eigh(s1)
    sqrt_s1 = (v1 * np.sqrt(np.clip(w1, 0.0, None))) @ v1.T
    inner = sqrt_s1 @ s2 @ sqrt_s1
    tr_covmean = np.sqrt(np.clip(np.linalg.eigvalsh((inner + inner.T) / 2), 0.0, None)).sum()
    diff = mu1 - mu2
    return {
        "fid": float(diff @ diff + np.trace(s1) + np.trace(s2) - 2.0 * tr_covmean),
        "trace_sum": float(np.trace(s1) + np.trace(s2)),
        "min_eig_real": float(w1.min()), "max_eig_real": float(w1.max()),
    }


def phase_fid(torch, np, ce, dev, gen, npz: str, n_img: int = 10_000, batch: int = 200) -> dict:
    from torchmetrics_tpu_torch.image import FrechetInceptionDistance
    from torchmetrics_tpu_torch.image._inception import InceptionFeatureExtractor
    from torchmetrics_tpu_torch.utilities.compute import full_fp32

    real = torch.randint(0, 256, (n_img, 3, 32, 32), generator=gen, device=dev, dtype=torch.uint8)
    noise = torch.randint(-20, 21, real.shape, generator=gen, device=dev, dtype=torch.int16)
    fake = (real.to(torch.int16) + 24 + noise).clamp_(0, 255).to(torch.uint8)  # brighter, noisier copies
    fid = FrechetInceptionDistance(feature=2048, weights_path=npz)
    fid.inception(real[:batch])  # first call: lazy CUDA module loading and cuDNN heuristics, not counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ce.matmul_bias_relu.launches = ce.bias_relu_.launches = ce.conv_bias_act.layout_copies = 0
    t0 = time.perf_counter()
    for start in range(0, n_img, batch):
        fid.update(real[start:start + batch], real=True)
        fid.update(fake[start:start + batch], real=False)
    torch.cuda.synchronize()
    t_updates = time.perf_counter() - t0
    value = fid.compute()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {
        "conv_mm_bias_relu": ce.matmul_bias_relu.launches,
        "bias_relu": ce.bias_relu_.launches,
        "layout_copies": ce.conv_bias_act.layout_copies,
    }
    peak = torch.cuda.max_memory_allocated()
    forwards = 2 * n_img // batch
    check(launches["conv_mm_bias_relu"] == 40 * forwards, f"B2a launches {launches} for {forwards} forwards")
    check(launches["bias_relu"] == 54 * forwards, f"B2b launches {launches} for {forwards} forwards")
    check(launches["layout_copies"] == 0, f"channels_last copies {launches['layout_copies']}")

    states = {k: v.double().cpu().numpy() for k, v in fid.state_dict(all_states=True).items()}
    check(states["real_features_num_samples"] == n_img and states["fake_features_num_samples"] == n_img, "sample counts")
    ref = host_fid(np, states)
    fid_err = abs(float(value) - ref["fid"])
    check(bool(torch.isfinite(value)) and fid_err <= FID_RTOL * abs(ref["fid"]),
          f"FID {float(value)} vs float64 host {ref['fid']}")

    # the trunk: fused bf16 (the main path) and fused float32 against the literal float32 conv+BN graph
    imgs = real[:batch]
    unfused32 = InceptionFeatureExtractor(weights_path=npz, compute_dtype=torch.float32, fuse_bn=False)(imgs)
    fused32 = InceptionFeatureExtractor(weights_path=npz, compute_dtype=torch.float32)(imgs)
    fused16 = fid.inception(imgs)
    check(fused16.shape == (batch, 2048) and bool(torch.isfinite(fused16).all()), "fused bf16 features not finite")
    rel32, rel16 = rel_norm(torch, fused32, unfused32), rel_norm(torch, fused16, unfused32)
    check(rel32 <= TRUNK_F32_RTOL, f"fused float32 trunk vs unfused: {rel32}")
    check(rel16 <= TRUNK_BF16_RTOL, f"fused bf16 trunk vs unfused float32: {rel16}")

    # one update's split: the trunk, then the statistics it folds in
    feats = fid.inception(imgs)

    def statistics_part():
        f = feats.float()
        with full_fp32():
            cov = f.T @ f
        fid.real_features_sum.add_(f.sum(dim=0))
        fid.real_features_cov_sum.add_(cov)

    trunk_ms = median_ms(torch, lambda: fid.inception(imgs), reps=10)
    stats_ms = median_ms(torch, statistics_part, reps=10)
    update_ms = wall_ms(torch, lambda: fid.update(imgs, real=True), reps=10)
    profile = device_time_by_kernel(torch, lambda: fid.update(imgs, real=True))
    result = {
        "phase": "fid_cifar10_10k", "images": 2 * n_img, "batch": batch, "forwards": forwards,
        "fid": float(value), "fid_float64_host": ref["fid"], "fid_rel_err": fid_err / abs(ref["fid"]),
        "trace_sum": ref["trace_sum"], "real_cov_eig_range": [ref["min_eig_real"], ref["max_eig_real"]],
        "launches": launches, "launches_per_forward": {"conv_mm_bias_relu": 40, "bias_relu": 54},
        "trunk_rel_err": {"fused_f32_vs_unfused_f32": rel32, "fused_bf16_vs_unfused_f32": rel16},
        "seconds": seconds, "images_per_s": 2 * n_img / seconds, "updates_seconds": t_updates,
        "compute_seconds": seconds - t_updates, "peak_mem_bytes": peak,
        "update_split_ms": {"trunk": trunk_ms, "statistics": stats_ms, "update_wall": update_ms},
        "update_profile": profile,
    }
    emit(result)
    return result


def phase_lpips(torch, lh, dev, gen, n_pairs: int = 1000, batch: int = 50, side: int = 256) -> dict:
    from torchmetrics_tpu_torch.image import LearnedPerceptualImagePatchSimilarity
    from torchmetrics_tpu_torch.image._lpips import LPIPSExtractor

    img0 = torch.rand((n_pairs, 3, side, side), generator=gen, device=dev) * 2 - 1
    img1 = (img0 + 0.2 * torch.randn(img0.shape, generator=gen, device=dev)).clamp_(-1, 1)
    metric = LearnedPerceptualImagePatchSimilarity()  # alex, bf16 trunk, seeded random weights
    metric.net(img0[:batch], img1[:batch])  # first call, not counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lh.lpips_head.launches = 0
    t0 = time.perf_counter()
    for start in range(0, n_pairs, batch):
        metric.update(img0[start:start + batch], img1[start:start + batch])
    score = metric.compute()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = lh.lpips_head.launches
    peak = torch.cuda.max_memory_allocated()
    updates = n_pairs // batch
    check(launches == 5 * updates, f"B3 launches {launches} for {updates} alex forwards")

    oracle = LPIPSExtractor(net_type="alex", unfused=True)  # same seed, same weights
    oracle_sum = sum(float(oracle(img0[s:s + batch], img1[s:s + batch]).double().sum()) for s in range(0, n_pairs, batch))
    got_sum = float(metric.sum_scores)
    check(abs(got_sum - oracle_sum) <= HEAD_RTOL * abs(oracle_sum), f"alex sum {got_sum} vs unfused {oracle_sum}")
    profile = device_time_by_kernel(torch, lambda: metric.update(img0[:batch], img1[:batch]))
    # the head stage alone, on one update's bf16 taps: B3 reads them as they are, so no copy,
    # fill or division kernel runs beside its 5 launches (only the sum of the taps' distances)
    lpnet, taps = metric.net.net, []
    hook = lpnet.net.register_forward_hook(lambda mod, args, out: taps.extend(out))
    try:
        metric.net(img0[:batch], img1[:batch])
    finally:
        hook.remove()
    with torch.no_grad():
        heads = device_time_by_kernel(torch, lambda: lpnet.heads(taps, batch), top=20)
    names = [(row["kernel"], row["calls"]) for row in heads["top"]]
    b3_calls = sum(calls for name, calls in names if "lpips_head_kernel" in name)
    extra = [name for name, _ in names if any(word in name.lower() for word in ("copy", "fill", "div"))]
    check(heads["kernels"] == 0 or (b3_calls == 5 and not extra), f"head stage kernels {names}")
    result = {
        "phase": "lpips_pairs", "pairs": n_pairs, "batch": batch, "net_type": "alex", "lpips": float(score),
        "unfused_mean": oracle_sum / n_pairs, "rel_err": abs(got_sum - oracle_sum) / abs(oracle_sum),
        "launches": launches, "seconds": seconds, "pairs_per_s": n_pairs / seconds, "peak_mem_bytes": peak,
        "update_profile": profile,
        "head_stage": {"tap_dtypes": sorted({str(t.dtype).split(".")[-1] for t in taps}), "device_busy_ms": heads["device_busy_ms"],
                       "kernels": [[name[:40], calls] for name, calls in names], "copy_fill_div_kernels": len(extra)},
        "others": {},
    }
    for net_type, taps in (("vgg", 5), ("squeeze", 7)):
        other = LearnedPerceptualImagePatchSimilarity(net_type=net_type)
        lh.lpips_head.launches = 0
        other.update(img0[:batch], img1[:batch])
        value = other.compute()
        torch.cuda.synchronize()
        count = lh.lpips_head.launches
        check(count == taps, f"{net_type}: B3 launches {count}, expected {taps}")
        want = LPIPSExtractor(net_type=net_type, unfused=True)(img0[:batch], img1[:batch])
        got = other.net(img0[:batch], img1[:batch])
        err = float(((got - want).abs() / want.abs()).max())
        check(err <= HEAD_RTOL, f"{net_type}: per-pair rel err {err} vs unfused")
        result["others"][net_type] = {"lpips": float(value), "launches": count, "per_pair_max_rel_err": err}
    emit(result)
    return result


def phase_image_timing(torch, ce, lh, calls, lpips_taps, dev, gen, smi: str) -> dict:
    """CUDA-event medians at the main path's shapes; per-forward sums weight each shape by its count."""
    meta = lambda shape: torch.empty(shape, device="meta", dtype=torch.bfloat16)  # noqa: E731
    rows = {"conv_mm_bias_relu": [], "bias_relu": [], "lpips_head": []}
    for call, count in collections.Counter(c for c in calls if is_pointwise(c)).items():
        m, k, n = gemm_shape(call)
        x = torch.randn((m, k), generator=gen, device=dev).relu_().bfloat16()
        w = (torch.randn((n, k), generator=gen, device=dev) / k**0.5).bfloat16()
        b = (0.1 * torch.randn(n, generator=gen, device=dev)).bfloat16()
        bound, by = bound_ms(ce.conv_bias_act_cost(meta(call[0]), meta(call[1]), meta((n,))), BF16_FLOPS_PER_S)
        rows["conv_mm_bias_relu"].append({
            "shape": [m, k, n], "hw": f"{call[0][2]}x{call[0][3]}", "count": count, "bound_ms": bound, "bound_by": by,
            "ms": median_ms(torch, lambda: ce.matmul_bias_relu(x, w, b), reps=30),
            "plain_ms": median_ms(torch, lambda: ce.matmul_bias_relu_plain(x, w, b), reps=10),
            "library_ms": median_ms(torch, lambda: torch.addmm(b, x, w.T).relu_(), reps=30),
        })
    for shape, count in collections.Counter(rows_shape(c) for c in calls if not is_pointwise(c)).items():
        y = torch.randn(shape, generator=gen, device=dev).bfloat16()
        b = (0.1 * torch.randn(shape[1], generator=gen, device=dev)).bfloat16()
        bound, by = bound_ms(ce.bias_relu_cost(y, b), F32_FLOPS_PER_S)
        rows["bias_relu"].append({
            "shape": list(shape), "count": count, "bound_ms": bound, "bound_by": by,
            "ms": median_ms(torch, lambda: ce.bias_relu_(y, b), reps=30),
            "plain_ms": median_ms(torch, lambda: ce.bias_relu_plain(y, b), reps=10),
            "library_ms": median_ms(torch, lambda: torch.add(y, b).relu_(), reps=30),
        })
    for shape in lpips_taps:  # the trunk's bf16 maps, as the main path hands them over; float32 beside
        f0 = torch.randn(shape, generator=gen, device=dev).relu_()
        f1 = (f0 + 0.3 * torch.randn(shape, generator=gen, device=dev)).relu_()
        w = torch.rand(shape[-1], generator=gen, device=dev)
        b0, b1 = f0.bfloat16(), f1.bfloat16()
        bound, by = bound_ms(lh.lpips_head_cost(b0, b1, w), F32_FLOPS_PER_S)
        rows["lpips_head"].append({
            "shape": list(shape), "count": 1, "bound_ms": bound, "bound_by": by,
            "ms": queued_ms(torch, lambda: lh.lpips_head(b0, b1, w)),
            "call_ms": median_ms(torch, lambda: lh.lpips_head(b0, b1, w), reps=30),
            "plain_ms": median_ms(torch, lambda: lh.lpips_head_plain(b0, b1, w), reps=10),
            "library_ms": None,
            "f32_ms": queued_ms(torch, lambda: lh.lpips_head(f0, f1, w)),
            "f32_call_ms": median_ms(torch, lambda: lh.lpips_head(f0, f1, w), reps=30),
            "f32_bound_ms": bound_ms(lh.lpips_head_cost(f0, f1, w), F32_FLOPS_PER_S)[0],
        })
    totals = {}
    for name, kernel_rows in rows.items():
        keys = [k for k in kernel_rows[0] if k.endswith("ms") and k != "library_ms"]
        total = {key: sum(r[key] * r["count"] for r in kernel_rows) for key in keys}
        lib = [r["library_ms"] for r in kernel_rows]
        total["library_ms"] = None if None in lib else sum(v * r["count"] for v, r in zip(lib, kernel_rows))
        total["launches_per_forward"] = sum(r["count"] for r in kernel_rows)
        by_bytes = sum(r["bound_ms"] * r["count"] for r in kernel_rows if r["bound_by"] == "bytes")
        total["bound_by"] = "bytes" if by_bytes >= total["bound_ms"] / 2 else "operations"
        totals[name] = total
    groups = {}  # B2a by activation size: 73x73 (K 64), 35x35 (K 192-288), 17x17 (K 768), 8x8 (K 1280-2048)
    for r in rows["conv_mm_bias_relu"]:
        group = groups.setdefault(r["hw"], {"launches": 0, "ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0, "K": set(), "N": set()})
        group["launches"] += r["count"]
        group["K"].add(r["shape"][1])
        group["N"].add(r["shape"][2])
        for key in ("ms", "bound_ms", "library_ms"):
            group[key] += r[key] * r["count"]
    for group in groups.values():
        group["K"], group["N"] = sorted(group["K"]), sorted(group["N"])
    emit({"phase": "image_timing", "per_forward": totals, "conv_mm_bias_relu_by_group": groups,
          "lpips_head_by_tap": [{k: r[k] for k in ("shape", "ms", "f32_ms", "bound_ms")} for r in rows["lpips_head"]],
          "card": smi,
          "at": {"conv": "one InceptionV3 forward, batch 200, bf16",
                 "lpips_head": "one alex LPIPS forward, 50 pairs of 256x256, bf16 maps (f32_*: float32 maps); "
                               "ms: queued_ms (device time), call_ms: median_ms (one call's CUDA events)"}})
    return totals


def phase_attention_vs_plain(torch, ka, dev, gen, path_mask) -> dict:
    """B4 against its plain version: the path's shapes and masks, odd lengths, a narrow head, fully masked rows."""
    hidden, heads = BERT_BASE["hidden_size"], BERT_BASE["num_heads"]
    # (B, L, hidden, heads, rows whose keys are all masked, mask): the path's own masks first, for
    # compute's (2999, 128) and a forward's (100, 128); None draws ragged lengths, as padded sentences
    shapes = [(*path_mask.shape, hidden, heads, 0, path_mask), (100, path_mask.shape[1], hidden, heads, 0, path_mask[:100]),
              (8, 1, hidden, heads, 1, None), (8, 37, hidden, heads, 1, None), (4, 509, hidden, heads, 1, None),
              (16, 50, 96, 4, 2, None)]
    cases, worst = 0, {"f32_abs": 0.0, "f32_rel_to_scale": 0.0, "bf16_abs": 0.0, "masked_row_vs_mean_v": 0.0}
    for bsz, length, hidden, heads, masked, mask in shapes:
        if mask is None:
            lens = torch.randint(max(1, length // 10), length + 1, (bsz,), generator=gen, device=dev)
            mask = (torch.arange(length, device=dev)[None, :] < lens[:, None]).long()
            mask[:masked] = 0
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn((bsz, length, hidden), generator=gen, device=dev).to(dtype) for _ in range(3))
            got = ka.attention(q, k, v, mask, num_heads=heads)
            ref = ka.attention_plain(q, k, v, mask, num_heads=heads)
            torch.cuda.synchronize()
            err = (got.float() - ref.float()).abs()
            scale = float(ref.float().abs().max())
            name = f"B4 ({bsz},{length},{hidden})/{heads} {str(dtype).split('.')[-1]}"
            if dtype == torch.float32:
                check(float(err.max()) <= ATT_F32_RTOL * scale, f"{name}: max abs err {float(err.max())} at scale {scale}")
                worst["f32_abs"] = max(worst["f32_abs"], float(err.max()))
                worst["f32_rel_to_scale"] = max(worst["f32_rel_to_scale"], float(err.max()) / scale)
                if masked:  # the oracle's uniform softmax: the mean of V over the L keys
                    dev_mean = float((got[:masked] - v[:masked].mean(dim=1, keepdim=True)).abs().max())
                    check(dev_mean <= ATT_F32_RTOL * scale, f"{name}: fully masked rows {dev_mean} from mean(V)")
                    worst["masked_row_vs_mean_v"] = max(worst["masked_row_vs_mean_v"], dev_mean)
            else:
                ok = bool((err <= ATT_BF16_ULP * ref.float().abs() + ATT_F32_RTOL * scale).all())
                check(ok, f"{name}: max abs err {float(err.max())} at scale {scale}")
                worst["bf16_abs"] = max(worst["bf16_abs"], float(err.max()))
            cases += 1
            del q, k, v, got, ref, err
    # a view one element into (B, L, hidden + 1) tensors defeats the kernel's 4-element loads: refused, not launched
    q = torch.randn((2, 8, 97), device=dev)[..., 1:]
    launches = ka.attention.launches
    try:
        ka.attention(q, q, q, torch.ones((2, 8), device=dev), num_heads=4)
        refused = False
    except ValueError:
        refused = True
    check(refused and ka.attention.launches == launches, "B4 launched on a view that is not 4-element aligned")
    emit({
        "phase": "attention_vs_plain", "cases": cases, "shapes": [list(sh[:5]) for sh in shapes], "worst": worst,
        "misaligned_view": "refused",
        "tolerance": {
            "float32": f"max|err| <= {ATT_F32_RTOL} * max|ref|, fully masked rows within that of mean(V)",
            "bfloat16": f"|err| <= 2**-7 * |ref| + {ATT_F32_RTOL} * max|ref| (one bf16 rounding step)",
        },
    })
    return {"max_abs_err": max(worst["f32_abs"], worst["bf16_abs"])}


def phase_layernorm_vs_plain(torch, ka, dev, gen, rows: int) -> dict:
    """B5 against its plain version at the path's (rows, 768) and at other widths, float32/bf16 inputs."""
    shapes = [(rows, 768), (1000, 70), (1000, 1000), (1000, 1024), (77, 2000)]
    cases, worst_abs, worst_rel = 0, 0.0, 0.0
    for r, c in shapes:
        for dx, dh in ((torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16), (torch.float32, torch.bfloat16)):
            x = torch.randn((r, c), generator=gen, device=dev).to(dx)
            h = torch.randn((r, c), generator=gen, device=dev).to(dh)
            scale = torch.rand(c, generator=gen, device=dev) + 0.5
            bias = 0.1 * torch.randn(c, generator=gen, device=dev)
            got = ka.layernorm_residual(x, h, scale, bias, eps=1e-12)
            ref = ka.layernorm_residual_plain(x, h, scale, bias, eps=1e-12)
            torch.cuda.synchronize()
            err, top = float((got - ref).abs().max()), float(ref.abs().max())
            check(got.dtype == torch.float32 and err <= LN_RTOL * top, f"B5 ({r},{c}) {dx}+{dh}: max abs err {err} at scale {top}")
            worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, err / top)
            cases += 1
    emit({
        "phase": "layernorm_residual_vs_plain", "cases": cases, "shapes": [list(sh) for sh in shapes],
        "inputs": ["f32+f32", "bf16+bf16", "f32+bf16"], "max_abs_err": worst_abs, "max_rel_to_scale": worst_rel,
        "tolerance": f"max|err| <= {LN_RTOL} * max|ref|",
    })
    return {"max_abs_err": worst_abs}


def bert_base_npz(torch, np, seed: int, folder: str) -> str:
    """Seeded random bert-base-uncased weights (with its MLM head) as the JAX package's flat ``.npz``."""
    from torchmetrics_tpu_torch.text._bert_encoder import BertConfig, _BertWithHead, init_bert_weights_
    from torchmetrics_tpu_torch.utilities.convert import bert_variables_from_state_dict, build_on_cpu

    config = BertConfig(**BERT_BASE, with_mlm_head=True)
    net = init_bert_weights_(build_on_cpu(_BertWithHead, config), seed)
    path = os.path.join(folder, "bert_base_uncased.npz")
    np.savez(path, **bert_variables_from_state_dict(net.state_dict(), config))
    return path


def token_corpus(np, rng, pairs: int, width: int, min_len: int, max_len: int, mean_len: float, vocab: int):
    """Pre-tokenized sentence pairs: [CLS] wordpieces [SEP], zero-padded to ``width``; predictions swap ~30% of the wordpieces."""
    lengths = np.clip(np.rint(rng.gamma(4.0, mean_len / 4.0, pairs)), min_len, max_len).astype(np.int64)
    cols = np.arange(width)[None, :]
    mask = (cols < lengths[:, None]).astype(np.int64)
    ids = rng.integers(1000, vocab, (pairs, width)) * mask  # wordpieces; BERT's vocab has its specials below 1000
    ids[:, 0] = SPECIAL_IDS["cls_token_id"]
    ids[np.arange(pairs), lengths - 1] = SPECIAL_IDS["sep_token_id"]
    swap = (rng.random((pairs, width)) < 0.3) & (cols > 0) & (cols < lengths[:, None] - 1)
    pred_ids = np.where(swap, rng.integers(1000, vocab, (pairs, width)), ids)
    return {"input_ids": pred_ids, "attention_mask": mask.copy()}, {"input_ids": ids, "attention_mask": mask}


def phase_bertscore(torch, np, ka, npz: str, corpus, batch: int = 100) -> dict:
    from torchmetrics_tpu_torch.functional.text.bert import _compute_idf, _greedy_cosine_matching, _idf_weights, bert_score
    from torchmetrics_tpu_torch.text import BERTScore
    from torchmetrics_tpu_torch.text._bert_encoder import BertEncoderExtractor

    preds, target = corpus
    n = target["input_ids"].shape[0]
    encoder = BertEncoderExtractor(npz)  # float32, on the card
    encoder(target["input_ids"][:8], target["attention_mask"][:8])  # first call: lazy module loading, not counted
    metric = BERTScore(model=encoder)
    sl = lambda enc, a: {k: v[a:a + batch] for k, v in enc.items()}  # noqa: E731
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ka.attention.launches = ka.layernorm_residual.launches = 0
    t0 = time.perf_counter()
    forwards = 0
    for u, start in enumerate(range(0, n, batch)):
        if u % 2 == 0:
            metric(sl(preds, start), sl(target, start))  # scores its batch: two encoder forwards
            forwards += 1
        else:
            metric.update(sl(preds, start), sl(target, start))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    before = (ka.attention.launches, ka.layernorm_residual.launches)
    out = metric.compute()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = {"attention": ka.attention.launches, "layernorm_residual": ka.layernorm_residual.launches}
    peak = torch.cuda.max_memory_allocated()
    encoder_forwards = 2 * (forwards + 1)
    layers = BERT_BASE["num_layers"]  # one B4 and two B5 per layer of each encoder forward
    check(launches["attention"] == layers * encoder_forwards and launches["layernorm_residual"] == 2 * layers * encoder_forwards,
          f"launches {launches} for {encoder_forwards} encoder forwards")
    compute_launches = [launches["attention"] - before[0], launches["layernorm_residual"] - before[1]]
    check(compute_launches == [2 * layers, 4 * layers], f"compute launched {compute_launches}, expected two forwards")

    idf_metric = BERTScore(model=encoder, idf=True)
    for start in range(0, n, batch):
        idf_metric.update(sl(preds, start), sl(target, start))
    ka.attention.launches = ka.layernorm_residual.launches = 0
    out_idf = idf_metric.compute()
    check([ka.attention.launches, ka.layernorm_residual.launches] == [2 * layers, 4 * layers], "idf compute launches")

    # the oracle: the literal unfused float32 graph on the card, scored by the same matcher
    oracle = BertEncoderExtractor(npz, unfused=True)
    dev = encoder.device
    on = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    pm, tm = on(preds["attention_mask"]), on(target["attention_mask"])
    pe, te = oracle(preds["input_ids"], pm), oracle(target["input_ids"], tm)
    idf_map = _compute_idf(target["input_ids"], target["attention_mask"])
    errs = {}
    for label, got, (pw, tw) in (
        ("idf_off", out, (pm.float(), tm.float())),
        ("idf_on", out_idf, (on(_idf_weights(preds["input_ids"], preds["attention_mask"], idf_map)),
                             on(_idf_weights(target["input_ids"], target["attention_mask"], idf_map)))),
    ):
        want = dict(zip(("precision", "recall", "f1"), _greedy_cosine_matching(pe, pm, te, tm, pw, tw)))
        for key in want:
            check(got[key].shape == (n,) and bool(torch.isfinite(got[key]).all()), f"{label} {key} shape/finite")
        errs[label] = max(float((got[k] - want[k]).abs().max()) for k in want)
        check(errs[label] <= BERTSCORE_ATOL, f"BERTScore {label} vs unfused oracle: {errs[label]}")
    del oracle, pe, te
    torch.cuda.empty_cache()
    profile = device_time_by_kernel(torch, lambda: bert_score(preds, target, model=encoder), top=8)
    result = {
        "phase": "bertscore_wmt", "pairs": n, "batch": batch, "tokens_per_side": int(target["attention_mask"].sum()),
        "f1_mean": float(out["f1"].mean()), "f1_mean_idf": float(out_idf["f1"].mean()),
        "max_abs_err_vs_unfused": errs, "tolerance": f"|err| <= {BERTSCORE_ATOL} on precision, recall, F1",
        "launches": launches, "encoder_forwards": encoder_forwards, "compute_launches": compute_launches,
        "seconds": t2 - t0, "pairs_per_s": n / (t2 - t0), "updates_seconds": t1 - t0, "compute_seconds": t2 - t1,
        "peak_mem_bytes": peak, "compute_profile": profile,
    }
    emit(result)
    return result


def phase_infolm(torch, np, ka, npz: str, corpus) -> dict:
    from torchmetrics_tpu_torch.functional.text import infolm
    from torchmetrics_tpu_torch.text import InfoLM
    from torchmetrics_tpu_torch.text._bert_encoder import BertMLMExtractor

    preds, target = corpus
    pairs, width = target["input_ids"].shape
    kw = dict(idf=True, information_measure="kl_divergence", temperature=0.25, max_length=width,
              special_tokens_map=SPECIAL_IDS, return_sentence_level_score=True)
    mlm = BertMLMExtractor(npz)
    mlm.logits_at(target["input_ids"][:4], target["attention_mask"][:4], 1)  # first call, not counted
    metric = InfoLM(model=mlm, **kw)
    metric.update(preds, target)
    torch.cuda.synchronize()
    ka.attention.launches = ka.layernorm_residual.launches = 0
    t0 = time.perf_counter()
    corpus_score, sentences = metric.compute()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"attention": ka.attention.launches, "layernorm_residual": ka.layernorm_residual.launches}
    layers = BERT_BASE["num_layers"]
    check(launches == {"attention": 2 * width * layers, "layernorm_residual": 4 * width * layers},
          f"InfoLM launches {launches} for 2 sides x {width} positions")
    want_corpus, want = infolm(preds, target, model=BertMLMExtractor(npz, unfused=True), **kw)
    err = float((sentences - want).abs().max())
    check(sentences.shape == (pairs,) and bool(torch.isfinite(sentences).all()), "InfoLM sentence scores")
    check(err <= INFOLM_RTOL * float(want.abs().max()) + INFOLM_ATOL, f"InfoLM vs unfused oracle: {err}")
    result = {
        "phase": "infolm_pairs", "pairs": pairs, "max_length": width, "measure": "kl_divergence", "idf": True,
        "infolm": float(corpus_score), "unfused": float(want_corpus), "max_abs_err_vs_unfused": err,
        "sentence_range": [float(sentences.min()), float(sentences.max())],
        "tolerance": f"|err| <= {INFOLM_RTOL} * max|ref| + {INFOLM_ATOL}",
        "launches": launches, "compute_seconds": seconds, "pairs_per_s": pairs / seconds,
    }
    emit(result)
    return result


def phase_text_timing(torch, ka, dev, gen, mask, smi: str) -> dict:
    """CUDA-event medians of B4 and B5 at one bertscore_wmt forward's shapes, per launch and per forward."""
    import torch.nn.functional as F

    bsz, length = mask.shape
    hidden, heads = BERT_BASE["hidden_size"], BERT_BASE["num_heads"]
    q, k, v = (torch.randn((bsz, length, hidden), generator=gen, device=dev) for _ in range(3))
    split = lambda t: t.view(bsz, length, heads, hidden // heads).transpose(1, 2)  # noqa: E731
    bias4 = ((1.0 - mask.float()) * -1e9)[:, None, None, :]
    scale, shift = torch.rand(hidden, generator=gen, device=dev) + 0.5, 0.1 * torch.randn(hidden, generator=gen, device=dev)
    rows = {}
    # B4 float32 runs its products on the tensor cores in three TF32 passes: 3x the operations at the TF32
    # peak, which stays under the bytes; the float32 FMA bound of the earlier kernel is kept beside it
    cost = ka.attention_cost(q, k, v, mask, num_heads=heads)
    att_bound, att_by = bound_ms(cost._replace(flops=3 * cost.flops), TF32_FLOPS_PER_S)
    rows["attention"] = {
        "count": BERT_BASE["num_layers"], "bound_ms": att_bound, "bound_by": att_by,
        "bound_ms_fma": bound_ms(cost, F32_FLOPS_PER_S)[0],
        "ms": median_ms(torch, lambda: ka.attention(q, k, v, mask, num_heads=heads), reps=10),
        "plain_ms": median_ms(torch, lambda: ka.attention_plain(q, k, v, mask, num_heads=heads), reps=3, warmup=1),
        "library_ms": median_ms(torch, lambda: F.scaled_dot_product_attention(split(q), split(k), split(v), attn_mask=bias4), reps=10),
    }
    qb, kb, vb = (t.bfloat16() for t in (q, k, v))
    bias4b = bias4.bfloat16()
    rows["attention_bf16"] = {  # compute_dtype=torch.bfloat16; not on the float32 main path
        "count": BERT_BASE["num_layers"],
        **dict(zip(("bound_ms", "bound_by"), bound_ms(ka.attention_cost(qb, kb, vb, mask, num_heads=heads), BF16_FLOPS_PER_S))),
        "ms": median_ms(torch, lambda: ka.attention(qb, kb, vb, mask, num_heads=heads), reps=10),
        "plain_ms": median_ms(torch, lambda: ka.attention_plain(qb, kb, vb, mask, num_heads=heads), reps=3, warmup=1),
        "library_ms": median_ms(torch, lambda: F.scaled_dot_product_attention(split(qb), split(kb), split(vb), attn_mask=bias4b), reps=10),
    }
    del qb, kb, vb
    ln_bound, ln_by = bound_ms(ka.layernorm_residual_cost(q, k, scale, shift), F32_FLOPS_PER_S)
    rows["layernorm_residual"] = {
        "count": 2 * BERT_BASE["num_layers"], "bound_ms": ln_bound, "bound_by": ln_by,
        "ms": median_ms(torch, lambda: ka.layernorm_residual(q, k, scale, shift, eps=1e-12), reps=20),
        "plain_ms": median_ms(torch, lambda: ka.layernorm_residual_plain(q, k, scale, shift, eps=1e-12), reps=5),
        "library_ms": median_ms(torch, lambda: F.layer_norm(q + k, (hidden,), scale, shift, 1e-12), reps=20),
    }
    per_forward = {
        name: {**{key: r[key] * r["count"] for key in ("ms", "plain_ms", "bound_ms", "library_ms")},
               "launches_per_forward": r["count"], "bound_by": r["bound_by"]}
        for name, r in rows.items()
    }
    per_forward["attention"]["bound_ms_fma"] = rows["attention"]["bound_ms_fma"] * rows["attention"]["count"]
    emit({"phase": "text_timing", "per_launch": rows, "per_forward": per_forward, "card": smi,
          "at": f"one bertscore_wmt encoder forward: ({bsz}, {length}, {hidden}), {heads} heads, float32 (attention_bf16: bf16)",
          "bound": {"attention": "max(bytes / 3.35 TB/s, 3 x flops / 495 TFLOP/s TF32); bound_ms_fma: flops / 67 TFLOP/s"},
          "library": {"attention": "F.scaled_dot_product_attention, additive float mask, on head-split views",
                      "layernorm_residual": "F.layer_norm(x + h), two calls"}})
    return per_forward


# ------------------------------------------------------------------ detection
COCO_HW = (480, 640)  # COCO val2017's most common image size (H, W)
SEGM_HW = (427, 640)  # the phase's mask size, also a COCO val2017 size
MAP_KEYS = ("map", "map_50", "map_75", "map_small", "map_medium", "map_large",
            "mar_1", "mar_10", "mar_100", "mar_small", "mar_medium", "mar_large")
# the card's compute vs the port's CPU compute of the same states: the same float32 arithmetic, the
# curves' sums of 0/1 in float32 (exact), so the summary means agree to their float64 host rounding
MAP_CPU_ATOL = 1e-6
MAP_COCO_ATOL = 1e-5  # vs the numpy pycocotools port (float64 IoUs): the JAX suite's own bbox tolerance
MAP_SEGM_ATOL = 1e-4  # vs the port in segm mode: the JAX suite's own tolerance (float32 mask IoU at ties)
IOU_F64_ATOL = 1e-6  # float32 IoU-family matrices and class means vs float64 numpy on the same boxes
PQ_MEAN_ATOL = 1e-6  # PQ from equal states, card vs CPU: a float32 mean of 133 per-category ratios
TEXT_DEFAULT_ATOL = {"bertscore": 1e-6, "infolm": 1e-5}  # hash encoders, card vs CPU run of the port


def _repo_module(name: str, relpath: str):
    """A numpy-only module of the repo's tests, loaded by its path (no package ``__init__`` runs)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, os.path.join(os.path.dirname(os.path.abspath(__file__)), relpath))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def coco_val_data(torch, dev, gen, n_img: int, n_cls: int = 80, dets: int = 100, max_gt: int = 50,
                  gt_per_image: int = 0) -> dict:
    """A COCO val2017-shaped detection stream made on the card from the seed.

    ``n_img`` images of 640x480; 1-50 ground truths each, 1 + a geometric law of
    mean ~6.4 (COCO val2017: 36,781 boxes on 5,000 images, 7.36 each), ~1% crowd;
    80 classes under a 1/(k+1)^0.9 law (a few frequent classes, as person is in
    COCO); box sides log-uniform on 6-450 px, so COCO's small (< 32^2), medium and
    large areas are all filled (~39/25/36%); ``dets`` detections an image (COCO's
    maxDets 100): half are jittered copies of a ground truth of their image,
    85% of those with its label, scored higher; the rest anywhere, scored lower.
    ``gt_per_image`` fixes the ground-truth count instead. Returns flat tensors
    and the per-image ground-truth counts (on the host).
    """
    import math

    h, w = COCO_HW
    u = lambda n: torch.rand(n, generator=gen, device=dev)  # noqa: E731
    normal = lambda n: torch.randn(n, generator=gen, device=dev)  # noqa: E731
    n_gt = torch.clamp(1 + torch.floor(-torch.log(u(n_img)) * 6.9), max=max_gt).long()
    if gt_per_image:
        n_gt = torch.full((n_img,), gt_per_image, device=dev)
    probs = (torch.arange(n_cls, device=dev) + 1.0) ** -0.9

    def labels(n):
        return torch.multinomial(probs, n, replacement=True, generator=gen).int()

    def boxes(n):
        side = torch.exp(math.log(6.0) + u(n) * math.log(450.0 / 6.0))
        ratio = torch.exp((u(n) * 2 - 1) * 0.7).sqrt()
        bw, bh = torch.clamp(side * ratio, max=w - 1), torch.clamp(side / ratio, max=h - 1)
        x, y = u(n) * (w - bw), u(n) * (h - bh)
        return torch.stack([x, y, x + bw, y + bh], dim=1)

    total, n_det = int(n_gt.sum()), n_img * dets
    gt_boxes, gt_labels, gt_crowd = boxes(total), labels(total), (u(total) < 0.01).int()
    img = torch.arange(n_det, device=dev) // dets
    pick = (torch.cumsum(n_gt, 0) - n_gt)[img] + torch.floor(u(n_det) * n_gt[img]).long()
    g = gt_boxes[pick]
    gw, gh = g[:, 2] - g[:, 0], g[:, 3] - g[:, 1]
    cx = (g[:, 0] + g[:, 2]) / 2 + normal(n_det) * 0.1 * gw
    cy = (g[:, 1] + g[:, 3]) / 2 + normal(n_det) * 0.1 * gh
    jw, jh = gw * torch.exp(normal(n_det) * 0.15), gh * torch.exp(normal(n_det) * 0.15)
    x1, y1 = torch.clamp(cx - jw / 2, 0, w - 1), torch.clamp(cy - jh / 2, 0, h - 1)  # inside the image, 1 px at least
    x2 = torch.maximum(torch.clamp(cx + jw / 2, max=w), x1 + 1)
    y2 = torch.maximum(torch.clamp(cy + jh / 2, max=h), y1 + 1)
    jittered = torch.stack([x1, y1, x2, y2], dim=1)
    hit = u(n_det) < 0.5
    return {
        "det_boxes": torch.where(hit[:, None], jittered, boxes(n_det)),
        "det_scores": torch.sigmoid(normal(n_det) + torch.where(hit, 1.0, -1.5)),
        "det_labels": torch.where(hit & (u(n_det) < 0.85), gt_labels[pick], labels(n_det)),
        "gt_boxes": gt_boxes, "gt_labels": gt_labels, "gt_crowd": gt_crowd,
        "gt_counts": n_gt.tolist(), "dets": dets,
    }


def det_batch(data: dict, lo: int, hi: int, geometry: str = "boxes"):
    """Images ``lo:hi`` of a stream as the metric's ``(preds, target)`` lists of per-image dicts (views)."""
    dets, counts = data["dets"], data["gt_counts"]
    start = sum(counts[:lo])
    preds, target = [], []
    for i in range(lo, hi):
        a, b = i * dets, (i + 1) * dets
        preds.append({geometry: data[f"det_{geometry}"][a:b], "scores": data["det_scores"][a:b],
                      "labels": data["det_labels"][a:b]})
        target.append({geometry: data[f"gt_{geometry}"][start:start + counts[i]],
                       "labels": data["gt_labels"][start:start + counts[i]], "iscrowd": data["gt_crowd"][start:start + counts[i]]})
        start += counts[i]
    return preds, target


def on_host(data: dict, lo: int, hi: int) -> dict:
    """Images ``lo:hi`` of a stream as numpy arrays for a worker process; masks stay behind (the host rebuilds them)."""
    start, dets = sum(data["gt_counts"][:lo]), data["dets"]
    stop = start + sum(data["gt_counts"][lo:hi])
    arrays = {k: v for k, v in data.items() if k not in ("gt_counts", "dets") and not k.endswith("_masks")}
    out = {k: v[lo * dets:hi * dets].cpu().numpy() for k, v in arrays.items() if k.startswith("det_")}
    out.update({k: v[start:stop].cpu().numpy() for k, v in arrays.items() if k.startswith("gt_")})
    return {**out, "gt_counts": data["gt_counts"][lo:hi], "dets": dets}


def _host_port_map(arrays: dict, batch: int, threads: int) -> dict:
    """Worker: the port's MeanAveragePrecision on the CPU over the same images in the same updates."""
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from torchmetrics_tpu_torch.detection import MeanAveragePrecision

    torch.set_num_threads(threads)
    data = {k: torch.from_numpy(v) if hasattr(v, "dtype") else v for k, v in arrays.items()}
    metric = MeanAveragePrecision(device="cpu")
    n = len(arrays["gt_counts"])
    t0 = time.perf_counter()
    for lo in range(0, n, batch):
        metric.update(*det_batch(data, lo, min(lo + batch, n)))
    out = metric.compute()
    return {"stats": {k: float(out[k]) for k in MAP_KEYS}, "seconds": time.perf_counter() - t0}


def rect_masks(xp, params, hw, dev=None):
    """``(n, H, W)`` bool masks, each the union of two integer rectangles ``params[k] = (y0, y1, x0, x1) x 2``.

    ``xp`` is ``torch`` (with ``dev``) or ``numpy``: both give the same bits.
    """
    h, w = hw
    rows = (xp.arange(h) if dev is None else xp.arange(h, device=dev))[None, :, None]
    cols = (xp.arange(w) if dev is None else xp.arange(w, device=dev))[None, None, :]
    p = params[:, :, None, None]
    first = (rows >= p[:, 0]) & (rows < p[:, 1]) & (cols >= p[:, 2]) & (cols < p[:, 3])
    return first | ((rows >= p[:, 4]) & (rows < p[:, 5]) & (cols >= p[:, 6]) & (cols < p[:, 7]))


def segm_data(torch, dev, gen, n_img: int, dets: int = 20, max_gt: int = 10, n_cls: int = 80) -> dict:
    """Mask-detection stream on the card: ``n_img`` 427x640 images, 1-10 ground-truth masks and ``dets`` detections each.

    A mask is the union of two integer rectangles (so the host rebuilds it bit
    for bit from its 8 numbers); a detection is a shifted copy of a ground truth
    of its image (60%, 85% of those with its label) or a mask anywhere.
    """
    h, w = SEGM_HW
    u = lambda n: torch.rand(n, generator=gen, device=dev)  # noqa: E731
    n_gt = torch.randint(1, max_gt + 1, (n_img,), generator=gen, device=dev)
    probs = (torch.arange(n_cls, device=dev) + 1.0) ** -0.9

    def labels(n):
        return torch.multinomial(probs, n, replacement=True, generator=gen).int()

    def params(n):
        out = []
        for _ in range(2):
            bh, bw = (torch.exp(u(n) * 4.5) * 4).long() + 2, (torch.exp(u(n) * 4.5) * 4).long() + 2
            y0, x0 = (u(n) * (h - bh)).long(), (u(n) * (w - bw)).long()
            out += [y0, y0 + bh, x0, x0 + bw]
        return torch.stack(out, dim=1)

    total, n_det = int(n_gt.sum()), n_img * dets
    gt_params, gt_labels = params(total), labels(total)
    img = torch.arange(n_det, device=dev) // dets
    pick = (torch.cumsum(n_gt, 0) - n_gt)[img] + torch.floor(u(n_det) * n_gt[img]).long()
    shift = torch.randint(-6, 7, (n_det, 1), generator=gen, device=dev).repeat(1, 8)
    shift[:, 2:4] = shift[:, 6:8] = torch.randint(-6, 7, (n_det, 1), generator=gen, device=dev)
    jittered = gt_params[pick] + shift
    hit = u(n_det) < 0.6
    det_params = torch.where(hit[:, None], jittered, params(n_det))
    data = {
        "det_params": det_params, "det_scores": torch.sigmoid(torch.randn(n_det, generator=gen, device=dev) + hit * 2.0),
        "det_labels": torch.where(hit & (u(n_det) < 0.85), gt_labels[pick], labels(n_det)),
        "gt_params": gt_params, "gt_labels": gt_labels, "gt_crowd": torch.zeros(total, dtype=torch.int32, device=dev),
        "gt_counts": n_gt.tolist(), "dets": dets,
    }
    data["det_masks"], data["gt_masks"] = rect_masks(torch, det_params, SEGM_HW, dev), rect_masks(torch, gt_params, SEGM_HW, dev)
    return data


def _host_pycocotools(arrays: dict, iou_type: str) -> dict:
    """Worker: the numpy pycocotools port (``tests/unittests/detection/pycocotools_port.py``) on the same images."""
    import numpy as np

    port = _repo_module("pycocotools_port", os.path.join("tests", "unittests", "detection", "pycocotools_port.py"))

    class Params(port.Params):
        """pycocotools' parameters with the metric's thresholds, as torchmetrics sets them for its pycocotools
        backend: ``linspace(...).round(2)``. The unrounded ``linspace`` puts some recall points an ulp off
        the recalls ``k / npig`` that land on them, and moves those samples (~1e-4 in map at 100 images)."""

        def __init__(self):
            super().__init__()
            self.iouThrs = np.linspace(0.5, 0.95, 10).round(2)
            self.recThrs = np.linspace(0.0, 1.00, 101).round(2)

    port.Params = Params
    if iou_type == "segm":
        arrays = {**arrays, "det_masks": rect_masks(np, arrays["det_params"], SEGM_HW),
                  "gt_masks": rect_masks(np, arrays["gt_params"], SEGM_HW)}
    t0 = time.perf_counter()
    preds, target = det_batch(arrays, 0, len(arrays["gt_counts"]), "boxes" if iou_type == "bbox" else "masks")
    stats = port.eval_tm_format(preds, target, iou_type=iou_type)
    return {"stats": {k: float(stats[k]) for k in MAP_KEYS}, "seconds": time.perf_counter() - t0}


def _top_level_imports(relpath: str) -> set:
    """The top-level packages a repo file imports, read from its source."""
    import ast

    tree = ast.parse(open(os.path.join(os.path.dirname(os.path.abspath(__file__)), relpath)).read())
    names = {alias.name for node in ast.walk(tree) if isinstance(node, ast.Import) for alias in node.names}
    names |= {node.module for node in ast.walk(tree) if isinstance(node, ast.ImportFrom) and node.module}
    return {name.split(".")[0] for name in names}


def _max_key_err(got: dict, want: dict) -> float:
    return max(abs(float(got[k]) - float(want[k])) for k in MAP_KEYS)


def phase_detection_coco_val(torch, np, dev, gen, pool, smi: str, n_img: int = 5000, batch: int = 16,
                             subset: int = 500) -> dict:
    """BASELINE config 3: ``MeanAveragePrecision(iou_type="bbox")`` over a COCO val2017-shaped stream on the card.

    The host references start first, in worker processes, and are read at the
    end of the detection phases: the port's own CPU run of the same 5,000
    images in the same updates, and the numpy pycocotools port on the first
    ``subset`` images, which a second metric on the card also evaluates.
    """
    from torchmetrics_tpu_torch.detection import MeanAveragePrecision

    port_imports = _top_level_imports(os.path.join("tests", "unittests", "detection", "pycocotools_port.py"))
    check(port_imports <= {"__future__", "collections", "numpy"}, f"the pycocotools port imports {port_imports}")
    data = coco_val_data(torch, dev, gen, n_img)
    pending = {"cpu": pool.submit(_host_port_map, on_host(data, 0, n_img), batch, 5),
               "pycocotools": pool.submit(_host_pycocotools, on_host(data, 0, subset), "bbox")}
    metric = MeanAveragePrecision(compute_with_cache=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for lo in range(0, n_img, batch):
        metric.update(*det_batch(data, lo, min(lo + batch, n_img)))
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = metric.compute()
    torch.cuda.synchronize()
    compute_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()
    check(all(out[k].device == dev and bool(torch.isfinite(out[k])) and -1 <= float(out[k]) <= 1 for k in MAP_KEYS),
          "coco_val: a summary value is off the card, not finite or outside [-1, 1]")
    check(out["classes"].numel() == 80 and 0.05 < float(out["map"]) < 0.95, f"coco_val: map {float(out['map'])}")

    per_class = MeanAveragePrecision(class_metrics=True, compute_with_cache=False)
    per_class.merge_state(metric)  # the same states
    t0 = time.perf_counter()
    pc = per_class.compute()
    torch.cuda.synchronize()
    class_ms = (time.perf_counter() - t0) * 1e3
    valid = pc["map_per_class"] > -1
    pc_err = max(_max_key_err(pc, out), abs(float(pc["map_per_class"][valid].mean()) - float(out["map"])))
    check(pc["map_per_class"].shape == (80,) and pc_err <= MAP_CPU_ATOL, f"coco_val class_metrics: {pc_err}")

    sub = MeanAveragePrecision()
    sub.update(*det_batch(data, 0, subset))
    sub_out = {k: float(v) for k, v in sub.compute().items() if k in MAP_KEYS}
    profile = device_time_by_kernel(torch, metric.compute, top=10)
    gts = sum(data["gt_counts"])
    return {
        "phase": "detection_coco_val", "images": n_img, "classes": 80, "detections": n_img * data["dets"],
        "ground_truths": gts, "crowd": int(data["gt_crowd"].sum()), "batch": batch,
        "results": {k: float(out[k]) for k in MAP_KEYS}, "subset_results": sub_out, "pending": pending,
        "max_err": {"class_metrics_run": pc_err},
        "seconds": stream_s, "images_per_s": n_img / stream_s, "update_ms": stream_s / -(-n_img // batch) * 1e3,
        "compute_ms": compute_ms, "class_metrics_compute_ms": class_ms, "peak_mem_bytes": peak,
        "compute_profile": profile, "card": smi,
    }


def phase_detection_stream(torch, dev, gen, n_updates: int = 1000) -> dict:
    """The JAX package's old streaming shape: 1 image an update, 100 detections and 20 ground truths."""
    from torchmetrics_tpu_torch.detection import MeanAveragePrecision

    data = coco_val_data(torch, dev, gen, n_updates, gt_per_image=20)
    metric, whole = MeanAveragePrecision(), MeanAveragePrecision()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n_updates):
        metric.update(*det_batch(data, i, i + 1))
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = metric.compute()
    torch.cuda.synchronize()
    compute_ms = (time.perf_counter() - t0) * 1e3
    whole.update(*det_batch(data, 0, n_updates))  # the same images in one update: the same states
    err = _max_key_err(whole.compute(), out)
    check(err <= MAP_CPU_ATOL, f"detection_stream: one update vs {n_updates} updates: {err}")
    return {"phase": "detection_stream", "updates": n_updates, "detections_per_image": data["dets"],
            "ground_truths_per_image": 20, "map": float(out["map"]), "max_err_vs_one_update": err,
            "seconds": stream_s, "updates_per_s": n_updates / stream_s, "compute_ms": compute_ms}


def phase_detection_segm(torch, np, dev, gen, pool, n_img: int = 100, batch: int = 10) -> dict:
    """``MeanAveragePrecision(iou_type="segm")`` on 100 images of 427x640 masks; the masks round-trip through COCO json."""
    from torchmetrics_tpu_torch.detection import MeanAveragePrecision

    data = segm_data(torch, dev, gen, n_img)
    pending = {"pycocotools": pool.submit(_host_pycocotools, on_host(data, 0, n_img), "segm")}
    metric = MeanAveragePrecision(iou_type="segm")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for lo in range(0, n_img, batch):
        metric.update(*det_batch(data, lo, lo + batch, "masks"))
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = metric.compute()
    torch.cuda.synchronize()
    compute_ms = (time.perf_counter() - t0) * 1e3
    with tempfile.TemporaryDirectory() as folder:
        name = os.path.join(folder, "segm")
        t0 = time.perf_counter()
        metric.tm_to_coco(name)
        preds, target = MeanAveragePrecision.coco_to_tm(f"{name}_preds.json", f"{name}_target.json", iou_type="segm")
        round_trip_s = time.perf_counter() - t0
    masks = 0
    for i in range(n_img):
        for side, entry in (("preds", preds[i]), ("target", target[i])):
            want = (metric.detection_mask if side == "preds" else metric.groundtruth_mask)[i].cpu().numpy()
            check(np.array_equal(entry["masks"].numpy().astype(bool), want), f"segm round trip: image {i} {side} masks")
            masks += len(want)
    return {"phase": "detection_segm", "images": n_img, "mask_hw": list(SEGM_HW), "detections": n_img * data["dets"],
            "ground_truths": sum(data["gt_counts"]), "results": {k: float(out[k]) for k in MAP_KEYS},
            "pending": pending, "round_trip": {"masks": masks, "exact": True, "seconds": round_trip_s},
            "seconds": stream_s, "compute_ms": compute_ms}


def _f64_box_family(np, a, b):
    """IoU, GIoU, DIoU and CIoU matrices of ``xyxy`` boxes in float64, written from their definitions."""
    a, b = a.astype(np.float64)[:, None, :], b.astype(np.float64)[None, :, :]
    area = lambda x: (x[..., 2] - x[..., 0]) * (x[..., 3] - x[..., 1])  # noqa: E731
    inter = (np.clip(np.minimum(a[..., 2], b[..., 2]) - np.maximum(a[..., 0], b[..., 0]), 0, None)
             * np.clip(np.minimum(a[..., 3], b[..., 3]) - np.maximum(a[..., 1], b[..., 1]), 0, None))
    union = area(a) + area(b) - inter
    iou = inter / union
    ew = np.maximum(a[..., 2], b[..., 2]) - np.minimum(a[..., 0], b[..., 0])
    eh = np.maximum(a[..., 3], b[..., 3]) - np.minimum(a[..., 1], b[..., 1])
    giou = iou - (ew * eh - union) / (ew * eh)
    centre = ((a[..., 0] + a[..., 2] - b[..., 0] - b[..., 2]) ** 2 + (a[..., 1] + a[..., 3] - b[..., 1] - b[..., 3]) ** 2) / 4
    diou = iou - centre / (ew**2 + eh**2)
    atan = lambda x: np.arctan((x[..., 2] - x[..., 0]) / (x[..., 3] - x[..., 1]))  # noqa: E731
    v = 4 / np.pi**2 * (atan(a) - atan(b)) ** 2
    return {"intersection_over_union": iou, "generalized_intersection_over_union": giou,
            "distance_intersection_over_union": diou, "complete_intersection_over_union": diou - v / (1 - iou + v) * v}


def panoptic_maps(torch, dev, gen, n: int, side: int = 512, things=range(1, 81), stuffs=range(92, 145)):
    """COCO-panoptic-like ``(n, side, side, 2)`` maps: a 16x16 grid of stuff regions, ~15 thing instances painted
    over it, ~4% void (category 0, unknown); the prediction moves each instance a few pixels, relabels 10% of
    the stuff cells and 10% of the instances, and drops or invents a few."""
    things, stuffs = torch.tensor(list(things), device=dev), torch.tensor(list(stuffs), device=dev)
    pick = lambda pool, shape: pool[torch.randint(0, len(pool), shape, generator=gen, device=dev)]  # noqa: E731
    grid = pick(stuffs, (n, 16, 16))
    noisy_grid = torch.where(torch.rand((n, 16, 16), generator=gen, device=dev) < 0.1, pick(stuffs, (n, 16, 16)), grid)
    cell = side // 16
    rows = torch.arange(side, device=dev)[None, :, None]
    cols = torch.arange(side, device=dev)[None, None, :]
    k = 15
    y0 = torch.randint(0, side - 40, (n, k), generator=gen, device=dev)
    x0 = torch.randint(0, side - 40, (n, k), generator=gen, device=dev)
    hh = torch.randint(16, 160, (n, k), generator=gen, device=dev)
    ww = torch.randint(16, 160, (n, k), generator=gen, device=dev)
    cat = pick(things, (n, k))
    dy, dx = (torch.randint(-4, 5, (n, k), generator=gen, device=dev) for _ in range(2))
    relabel = torch.rand((n, k), generator=gen, device=dev) < 0.1
    keep = torch.rand((n, k), generator=gen, device=dev) < 0.9
    pred_cat = torch.where(relabel, pick(things, (n, k)), cat)

    def paint(stuff_grid, cats, ys, xs, present):
        c = stuff_grid.repeat_interleave(cell, 1).repeat_interleave(cell, 2)
        inst = torch.zeros_like(c)
        for j in range(k):
            inside = ((rows >= ys[:, j, None, None]) & (rows < (ys + hh)[:, j, None, None]) & (cols >= xs[:, j, None, None])
                      & (cols < (xs + ww)[:, j, None, None]) & present[:, j, None, None])
            c = torch.where(inside, cats[:, j, None, None], c)
            inst = torch.where(inside, j + 1, inst)
        return torch.stack([c, inst], dim=-1)

    target = paint(grid, cat, y0, x0, torch.ones_like(keep))
    void = torch.rand((n, 16, 16), generator=gen, device=dev).repeat_interleave(cell, 1).repeat_interleave(cell, 2) < 0.04
    target[..., 0] = torch.where(void, 0, target[..., 0])
    preds = paint(noisy_grid, pred_cat, y0 + dy, x0 + dx, keep)
    return preds, target, set(range(1, 81)), set(range(92, 145))


def phase_iou_panoptic(torch, np, dev, gen) -> dict:
    """The IoU family on 16 images of 100 x 100 boxes against float64 numpy, and PQ / modified PQ on 8 COCO-panoptic-like
    512x512 maps against the port's CPU run (exactly) and the golden cases 162/163."""
    import torchmetrics_tpu_torch as tt
    import torchmetrics_tpu_torch.functional as F

    n_img, n_box, n_cls = 16, 100, 5
    xy = torch.rand((2, n_img, n_box, 2), generator=gen, device=dev) * 100
    boxes = torch.cat([xy, xy + torch.rand((2, n_img, n_box, 2), generator=gen, device=dev) * 30 + 2], dim=-1)
    labels = torch.randint(0, n_cls, (2, n_img, n_box), generator=gen, device=dev)
    host_boxes, host_labels = boxes.cpu().numpy(), labels.cpu().numpy()
    classes = {"intersection_over_union": tt.IntersectionOverUnion, "generalized_intersection_over_union":
               tt.GeneralizedIntersectionOverUnion, "distance_intersection_over_union": tt.DistanceIntersectionOverUnion,
               "complete_intersection_over_union": tt.CompleteIntersectionOverUnion}
    errs, results = {}, {}
    refs = [_f64_box_family(np, host_boxes[0, i], host_boxes[1, i]) for i in range(n_img)]
    for name, cls in classes.items():
        err = 0.0
        for i in range(n_img):
            mat = getattr(F, name)(boxes[0, i], boxes[1, i], aggregate=False)
            err = max(err, float(np.abs(mat.cpu().numpy() - refs[i][name]).max()))
        metric = cls(class_metrics=True)
        metric.update([{"boxes": boxes[0, i], "labels": labels[0, i]} for i in range(n_img)],
                      [{"boxes": boxes[1, i], "labels": labels[1, i]} for i in range(n_img)])
        got = metric.compute()
        same = [host_labels[0, i][:, None] == host_labels[1, i][None, :] for i in range(n_img)]
        want = {metric._iou_type: np.concatenate([refs[i][name][same[i]] for i in range(n_img)]).mean()}
        for c in range(n_cls):
            col = [refs[i][name][:, host_labels[1, i] == c][same[i][:, host_labels[1, i] == c]] for i in range(n_img)]
            want[f"{metric._iou_type}/cl_{c}"] = np.concatenate(col).mean()
        check(sorted(got) == sorted(want), f"{name}: keys {sorted(got)}")
        err = max(err, *(abs(float(got[k]) - want[k]) for k in want))
        check(err <= IOU_F64_ATOL, f"{name} vs float64: {err}")
        errs[name], results[metric._iou_type] = err, float(got[metric._iou_type])

    preds, target, things, stuffs = panoptic_maps(torch, dev, gen, 8)
    pq_out = {}
    for cls in (tt.PanopticQuality, tt.ModifiedPanopticQuality):
        card, host = cls(things=things, stuffs=stuffs), cls(things=things, stuffs=stuffs, device="cpu")
        t0 = time.perf_counter()
        for lo in (0, 4):
            card.update(preds[lo:lo + 4], target[lo:lo + 4])
        value = card.compute()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        for lo in (0, 4):
            host.update(preds[lo:lo + 4].cpu(), target[lo:lo + 4].cpu())
        for state in ("iou_sum", "true_positives", "false_positives", "false_negatives"):
            check(torch.equal(getattr(card, state).cpu(), getattr(host, state)), f"{cls.__name__} {state}: card != CPU")
        # equal states; the mean over the 133 categories is a float32 sum in the device's own order
        diff = abs(float(value) - float(host.compute()))
        check(diff <= PQ_MEAN_ATOL and 0.1 < float(value) < 1.0, f"{cls.__name__} {float(value)}, vs CPU {diff}")
        pq_out[cls.__name__] = {"value": float(value), "diff_vs_cpu": diff, "ms": ms}

    specs = _repo_module("golden_specs", os.path.join("tests", "helpers", "golden_specs.py")).SPECS
    pack = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "goldens", "goldens.npz"))
    golden_err = {}
    for idx in (158, 159, 160, 161, 162, 163):
        spec = specs[idx]
        got = getattr(F, spec.fn)(*[torch.from_numpy(a).to(dev) for a in spec.make()], **spec.kwargs)
        want = pack[f"{idx:03d}_{spec.fn}/0"].astype(np.float64)
        golden_err[idx] = float(abs(got.double().cpu().numpy() - want).max())
        check(np.allclose(got.double().cpu().numpy(), want, atol=spec.atol, rtol=1e-4), f"golden {idx} {spec.fn}: {golden_err[idx]}")
    out = {"phase": "iou_panoptic", "boxes": [n_img, n_box, n_box], "results": results, "max_abs_err_vs_float64": errs,
           "tolerance": IOU_F64_ATOL, "panoptic": {"maps": list(preds.shape), "things": len(things), "stuffs": len(stuffs),
           **pq_out, "check": f"states equal to the CPU run, value within {PQ_MEAN_ATOL}"}, "golden_max_err": golden_err}
    emit(out)
    return out


def finish_detection(coco: dict, segm: dict, t_start: float) -> None:
    """Read the detection phases' host references (worker processes), check them, and print the phases' lines.

    ``t_start`` is when phases 17-21 began: their wall time, waits included, goes on the coco_val line.
    """
    pending = coco.pop("pending")
    cpu, ref = pending["cpu"].result(), pending["pycocotools"].result()
    cpu_err = _max_key_err(cpu["stats"], coco["results"])
    check(cpu_err <= MAP_CPU_ATOL, f"coco_val: card vs the port's CPU run: {cpu_err}")
    ref_err = _max_key_err(ref["stats"], coco.pop("subset_results"))
    check(ref_err <= MAP_COCO_ATOL, f"coco_val subset vs the pycocotools port: {ref_err}")
    coco["max_err"].update(cpu_run=cpu_err, pycocotools_port_subset=ref_err)
    coco["tolerance"] = {"cpu_run": MAP_CPU_ATOL, "pycocotools_port_subset": MAP_COCO_ATOL,
                         "class_metrics_run": MAP_CPU_ATOL}
    coco["host_seconds"] = {"cpu_run": cpu["seconds"], "pycocotools_port_subset": ref["seconds"]}
    coco["phases_17_21_seconds"] = time.perf_counter() - t_start
    emit(coco)
    ref = segm.pop("pending")["pycocotools"].result()
    err = _max_key_err(ref["stats"], segm["results"])
    check(err <= MAP_SEGM_ATOL, f"segm vs the pycocotools port: {err}")
    segm["results"] = {k: segm["results"][k] for k in ("map", "map_50", "map_75", "mar_100")}
    segm.update(max_err_vs_pycocotools_port=err, tolerance=MAP_SEGM_ATOL, host_seconds=ref["seconds"])
    emit(segm)


def _host_text_no_model(kind: str, preds: dict, target: dict) -> dict:
    """Worker: BERTScore() or InfoLM() without a model on the CPU: its token-id states and its scores."""
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from torchmetrics_tpu_torch.text import BERTScore, InfoLM

    torch.set_num_threads(2)
    metric = BERTScore(device="cpu") if kind == "bertscore" else InfoLM(device="cpu", return_sentence_level_score=True)
    metric.update(preds, target)
    out = metric.compute()
    scores = out["f1"] if kind == "bertscore" else out[1]
    return {"ids": [torch.cat(getattr(metric, f"{side}_input_ids")).numpy() for side in ("preds", "target")],
            "scores": scores.numpy()}


def submit_text_no_model(pool, corpora: dict, pairs: int = 64) -> dict:
    """Start the CPU runs of the no-model text metrics on the first ``pairs`` pairs of each corpus."""
    head = lambda enc: {k: v[:pairs] for k, v in enc.items()}  # noqa: E731
    return {kind: pool.submit(_host_text_no_model, kind, head(preds), head(target))
            for kind, (preds, target) in corpora.items()}


def phase_text_no_model(torch, np, corpora: dict, pending: dict, pairs: int = 64) -> None:
    """``BERTScore()`` and ``InfoLM()`` built without a model (the hash encoders) on the card, against the CPU run."""
    from torchmetrics_tpu_torch.text import BERTScore, InfoLM

    out = {"phase": "text_no_model", "pairs": pairs}
    for kind, (preds, target) in corpora.items():
        metric = BERTScore() if kind == "bertscore" else InfoLM(return_sentence_level_score=True)
        head = lambda enc: {k: v[:pairs] for k, v in enc.items()}  # noqa: E731
        metric.update(head(preds), head(target))
        t0 = time.perf_counter()
        res = metric.compute()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        scores = res["f1"] if kind == "bertscore" else res[1]
        host = pending[kind].result()
        for side, want in zip(("preds", "target"), host["ids"]):
            check(np.array_equal(torch.cat(getattr(metric, f"{side}_input_ids")).cpu().numpy(), want), f"{kind} {side} ids")
        err = float(np.abs(scores.cpu().numpy() - host["scores"]).max())
        check(scores.shape == (pairs,) and bool(torch.isfinite(scores).all()), f"{kind} no-model scores")
        check(err <= TEXT_DEFAULT_ATOL[kind], f"{kind} no model, card vs CPU: {err}")
        out[kind] = {"corpus": "bertscore_wmt" if kind == "bertscore" else "infolm_pairs", "mean": float(scores.mean()),
                     "max_abs_err_vs_cpu": err, "tolerance": TEXT_DEFAULT_ATOL[kind], "ids": "exact", "compute_ms": ms}
    emit(out)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from torchmetrics_tpu_torch.classification import MulticlassAccuracy, MulticlassConfusionMatrix
    from torchmetrics_tpu_torch.functional.classification import _confmat_kernel as kernel
    from torchmetrics_tpu_torch.functional.classification.confusion_matrix import _multiclass_confusion_matrix_format
    from torchmetrics_tpu_torch.image._inception import InceptionFeatureExtractor
    from torchmetrics_tpu_torch.utilities import nvcc

    # the kernel modules by path: `_kernels` exports a function named like its module
    ce = importlib.import_module("torchmetrics_tpu_torch._kernels.conv_epilogue")
    lh = importlib.import_module("torchmetrics_tpu_torch._kernels.lpips_head")
    ka = importlib.import_module("torchmetrics_tpu_torch._kernels.attention")
    confmat_cuda, confmat_plain = kernel.confusion_matrix_cuda, kernel.confusion_matrix_plain
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions' float32 matrix products stay in full float32
    device_name = torch.cuda.get_device_name(0)

    # ------------------------------------------------------------------ build
    t0 = time.perf_counter()
    libraries = {
        "confmat": (kernel.SOURCE, kernel._library),
        "conv_epilogue": (ce.SOURCE, ce._library),
        "lpips_head": (lh.SOURCE, lh._library),
        "attention": (ka.ATTENTION_SOURCE, ka._attention_library),
        "layernorm_residual": (ka.LAYERNORM_SOURCE, ka._layernorm_library),
    }
    infos = dict(zip(libraries, nvcc.build_all([source for source, _ in libraries.values()])))  # one nvcc each, at once
    for _, load in libraries.values():
        load()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    # the kernels redesigned for Hopper: registers and spills from ptxas, dynamic shared memory from the library
    redesigned = ptxas_templates(infos["conv_epilogue"]["log"], "mm_bias_relu_tma")
    for key, value in redesigned.items():
        value["smem_bytes"] = ce._library().tm_mm_bias_relu_tma_smem(int(key.split("<")[1][:-1]))
    for template in ("attention_tf32x3", "attention_bf16"):
        for key, value in ptxas_templates(infos["attention"]["log"], template).items():
            value["smem_bytes"] = ka._attention_library().tm_attention_smem(int("bf16" in key), int(key.split("<")[1][:-1]))
            redesigned[key] = value
    # B1 and B3: the instantiations the main paths run, int64 labels under a mask and bf16 maps in
    # 16-byte vectors (1-3 a lane); their dynamic shared memory is 4 * C bytes
    main_path = {"confmat_kernel<i64,1>", *(f"lpips_head_kernel<bf16,8,{k}>" for k in (1, 2, 3))}
    for lib_name, template in (("confmat", "confmat_kernel"), ("lpips_head", "lpips_head_kernel")):
        redesigned.update({k: v for k, v in ptxas_templates(infos[lib_name]["log"], template).items() if k in main_path})
    emit({
        "phase": "build",
        "seconds": round(time.perf_counter() - t0, 3),
        "libraries": {
            name: {"nvcc_seconds": round(info["seconds"], 3), "built": info["built"], **ptxas_summary(info["log"])}
            for name, info in infos.items()
        },
        "redesigned_kernels": {k: [v.get("registers"), v.get("spill_bytes"), v.get("smem_bytes", v.get("static_smem_bytes"))]
                               for k, v in redesigned.items()},
        "redesigned_fields": ["registers", "spill_bytes", "smem_bytes (confmat_kernel, lpips_head_kernel: static, "
                              "plus 4 * C dynamic: diagonal counters; head weights)"],
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "device": device_name,
    })
    print(smi, flush=True)

    # -------------------------------------------------------- kernel_vs_plain
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    cases = [
        # (n, C, label dtype, weights, labels)
        (8, 256, torch.int32, None, "uniform"),
        (517, 300, torch.int64, "mask", "uniform"),
        (1024, 1000, torch.int64, "mask", "uniform"),
        (1024, 1000, torch.int32, None, "uniform"),
        (1001, 1001, torch.int32, "float", "uniform"),
        (4_194_304, 847, torch.int64, "mask", "uniform"),
        (4_194_304, 847, torch.int32, "float", "uniform"),
        (1_000_000, 1000, torch.int64, None, "diagonal"),
        (1_000_000, 1000, torch.int32, "float", "diagonal"),
        (100_000, 300, torch.int64, None, "out_of_range"),
        (100_000, 300, torch.int32, "mask", "out_of_range"),
        (100_000, 300, torch.int64, "float", "out_of_range"),
        # views 3 and 1 rows into their arrays: the kernel's scalar head before its 16-byte loads
        (100_003, 300, torch.int64, "mask", "offset_3"),
        (100_001, 300, torch.int32, "float", "offset_1"),
    ]
    max_abs_err = 0.0
    for n, c, dtype, wkind, labels in cases:
        lo, hi = (-2, c + 2) if labels == "out_of_range" else (0, c)
        skip = int(labels.split("_")[1]) if labels.startswith("offset") else 0
        t = torch.randint(lo, hi, (n + skip,), generator=gen, device=dev, dtype=dtype)[skip:]
        p = t.clone() if labels == "diagonal" else torch.randint(lo, hi, (n + skip,), generator=gen, device=dev, dtype=dtype)[skip:]
        w = None
        if wkind == "mask":
            w = (torch.rand(n + skip, generator=gen, device=dev) < 0.9)[skip:]
        elif wkind == "float":
            w = torch.rand(n + skip, generator=gen, device=dev)[skip:]
        got = confmat_cuda(p, t, c, w)
        ref = confmat_plain(p, t, c, w)
        torch.cuda.synchronize()
        check(got.dtype == ref.dtype and got.shape == (c, c), f"dtype/shape {got.dtype} {ref.dtype} {got.shape}")
        err = float((got.double() - ref.double()).abs().max())
        in_range = (t >= 0) & (t < c) & (p >= 0) & (p < c)
        if wkind == "float":
            ok = torch.allclose(got, ref, rtol=FLOAT_RTOL, atol=FLOAT_ATOL)
            expected_total = float((w.double() * in_range).sum())
            total_ok = abs(float(got.double().sum()) - expected_total) <= 1e-5 * expected_total + 1e-3
        else:
            ok = torch.equal(got, ref)
            expected = in_range if w is None else in_range & w
            total_ok = int(got.sum()) == int(expected.sum())
        case = f"({n},{c}) {str(dtype).split('.')[-1]} {wkind or 'none'} {labels}"
        check(ok, f"kernel != plain at {case}: max abs err {err}")
        check(total_ok, f"kernel total != count of valid in-range rows at {case}")
        max_abs_err = max(max_abs_err, err)
    emit({
        "phase": "kernel_vs_plain", "cases": len(cases), "max_abs_err": max_abs_err,
        "tolerance": {"counts": "exact", "float32_weights": {"rtol": FLOAT_RTOL, "atol": FLOAT_ATOL}},
    })

    # ----------------------------------------------------------- imagenet_val
    n_val, c_in, batch = 50_000, 1000, 1024
    logits = torch.randn((n_val, c_in), generator=gen, device=dev)
    target = torch.randint(0, c_in, (n_val,), generator=gen, device=dev)
    hit = torch.rand(n_val, generator=gen, device=dev) < 0.76
    rows = torch.arange(n_val, device=dev)
    logits[rows[hit], target[hit]] += 10.0  # ~76% of rows have their argmax on the target
    metrics = [
        MulticlassAccuracy(num_classes=c_in, average="micro"),
        MulticlassAccuracy(num_classes=c_in, average="micro", top_k=5),
        MulticlassConfusionMatrix(num_classes=c_in),
    ]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    confmat_cuda.launches = 0
    t0 = time.perf_counter()
    first_batch_vals = None
    n_batches = 0
    for b, start in enumerate(range(0, n_val, batch)):
        p, t = logits[start:start + batch], target[start:start + batch]
        if b % 2 == 0:
            vals = [m(p, t) for m in metrics]
            first_batch_vals = first_batch_vals or vals
        else:
            for m in metrics:
                m.update(p, t)
        n_batches += 1
    top1, top5, cm = (m.compute() for m in metrics)
    torch.cuda.synchronize()
    imagenet_s = time.perf_counter() - t0
    imagenet_launches = confmat_cuda.launches

    host_logits, host_target = logits.cpu().numpy(), target.cpu().numpy()
    pred1 = host_logits.argmax(axis=1)
    in_top5 = (np.argpartition(-host_logits, 4, axis=1)[:, :5] == host_target[:, None]).any(axis=1)
    ref_cm = np.bincount(host_target * c_in + pred1, minlength=c_in * c_in).reshape(c_in, c_in)
    ref_top1 = np.float32((pred1 == host_target).sum()) / np.float32(n_val)
    ref_top5 = np.float32(in_top5.sum()) / np.float32(n_val)
    ref_b0 = np.float32((pred1[:batch] == host_target[:batch]).sum()) / np.float32(batch)
    check(float(top1) == float(ref_top1), f"top-1 {float(top1)} != host {float(ref_top1)}")
    check(float(top5) == float(ref_top5), f"top-5 {float(top5)} != host {float(ref_top5)}")
    check(float(first_batch_vals[0]) == float(ref_b0), "forward's batch top-1 != host")
    check(np.array_equal(cm.cpu().numpy(), ref_cm), "confusion matrix != host bincount")
    check(imagenet_launches == metrics[2].update_count == n_batches,
          f"confmat launches {imagenet_launches}, updates {metrics[2].update_count}, batches {n_batches}")
    emit({
        "phase": "imagenet_val", "samples": n_val, "classes": c_in, "batches": n_batches,
        "top1": float(top1), "top5": float(top5), "confmat_launches": imagenet_launches,
        "seconds": imagenet_s, "batches_per_s": n_batches / imagenet_s, "samples_per_s": n_val / imagenet_s,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
    })

    # ----------------------- confmat_exact_2p24, classification_collection, aggregation
    exact_launches = phase_confmat_exact_2p24(torch, kernel, dev)
    collection = phase_classification_collection(torch, np, kernel, dev, gen, smi)
    phase_aggregation(torch, np, dev, gen)

    # ------------------------------------------------------------ ade20k_full
    c_ade, maps, side, n_updates = 847, 16, 512, 8
    shape = (n_updates, maps, side, side)
    seg_target = torch.randint(0, c_ade, shape, generator=gen, device=dev)
    void = torch.rand(shape, generator=gen, device=dev) < 0.10
    seg_target[void] = -1
    correct = (torch.rand(shape, generator=gen, device=dev) < 0.70) & ~void
    seg_preds = torch.where(correct, seg_target, torch.randint(0, c_ade, shape, generator=gen, device=dev))
    ade = MulticlassConfusionMatrix(num_classes=c_ade, ignore_index=-1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    confmat_cuda.launches = 0
    t0 = time.perf_counter()
    for u in range(n_updates):
        ade.update(seg_preds[u], seg_target[u])
    ade_cm = ade.compute()
    torch.cuda.synchronize()
    ade_s = time.perf_counter() - t0
    ade_launches = confmat_cuda.launches
    ade_peak = torch.cuda.max_memory_allocated()

    ref = torch.zeros((c_ade, c_ade), dtype=torch.int32, device=dev)
    for u in range(n_updates):
        t = seg_target[u].reshape(-1)
        ref += confmat_plain(seg_preds[u].reshape(-1), t, c_ade, t != -1)
    check(torch.equal(ade_cm, ref), "ADE20K confusion matrix != plain version")
    check(int(ade_cm.sum()) == int((~void).sum()), "ADE20K count != number of non-void pixels")
    check(ade_launches == ade.update_count == n_updates, f"confmat launches {ade_launches} != {n_updates} updates")
    pixels = n_updates * maps * side * side
    emit({
        "phase": "ade20k_full", "classes": c_ade, "updates": n_updates, "pixels": pixels,
        "void_share": float(void.float().mean()), "pixel_accuracy": float(ade_cm.diagonal().sum() / ade_cm.sum()),
        "confmat_launches": ade_launches, "seconds": ade_s, "updates_per_s": n_updates / ade_s,
        "pixels_per_s": pixels / ade_s, "peak_mem_bytes": ade_peak,
    })

    # ---------------- ade20k_miou, classification_rest, coco_multilabel, dice_fairness
    miou_launches = phase_ade20k_miou(torch, np, kernel, dev, seg_preds, seg_target, ade_cm, smi)
    rest_launches = phase_classification_rest(torch, np, kernel, dev, logits, target, smi)
    phase_coco_multilabel(torch, np, dev, gen, smi)
    phase_dice_fairness(torch, np, dev, gen, smi)

    # ----------------------------------------------------------------- timing
    shapes = {}
    main_inputs = {
        "imagenet_batch": (_multiclass_confusion_matrix_format(logits[:batch], target[:batch], None), c_in),
        "ade20k_update": (_multiclass_confusion_matrix_format(seg_preds[0], seg_target[0], -1), c_ade),
    }
    for name, ((p, t, valid), c) in main_inputs.items():
        n = p.numel()
        fused = (t * c + p)[valid]
        state = torch.zeros((c, c), dtype=torch.int32, device=dev)
        out = confmat_cuda(p, t, c, valid)
        plain_reps = 20 if n < 100_000 else 5
        label_bytes = n * (2 * p.element_size() + valid.element_size())
        # the main path adds into the metric's state: the labels are read once and only touched cells
        # change; a fresh matrix (the functional API) also zeroes and writes all C * C * 4 bytes
        bound = label_bytes / HBM_BYTES_PER_S * 1e3
        ms = queued_ms(torch, lambda: confmat_cuda(p, t, c, valid, out=state), reps=50)
        shapes[name] = {
            "n": n, "classes": c, "labels": str(p.dtype).split(".")[-1], "weights": "bool mask",
            "ms": ms,
            "call_ms": median_ms(torch, lambda: confmat_cuda(p, t, c, valid, out=state), reps=50),
            "fresh_call_ms": median_ms(torch, lambda: confmat_cuda(p, t, c, valid), reps=50),
            "bound_ms": bound,
            "bound_ms_fresh": (label_bytes + c * c * 4) / HBM_BYTES_PER_S * 1e3,
            "bound_share": bound / ms,
            "zeros_ms": median_ms(torch, lambda: torch.zeros((c, c), dtype=torch.int32, device=dev), reps=50),
            "state_add_ms": median_ms(torch, lambda: state.add_(out), reps=50),
            "plain_ms": median_ms(torch, lambda: confmat_plain(p, t, c, valid), reps=plain_reps, warmup=1),
            "plain_reps": plain_reps,
            "library_ms": median_ms(torch, lambda: torch.bincount(fused, minlength=c * c), reps=50),
            "launches_per_update": 1,
        }
    # one metric call at a time, on the host clock: where a batch's time goes
    p_in, t_in = logits[:batch], target[:batch]
    per_metric = {}
    for label, make in (
        ("imagenet_top1_accuracy", lambda: MulticlassAccuracy(num_classes=c_in, average="micro")),
        ("imagenet_top5_accuracy", lambda: MulticlassAccuracy(num_classes=c_in, average="micro", top_k=5)),
        ("imagenet_confusion_matrix", lambda: MulticlassConfusionMatrix(num_classes=c_in)),
    ):
        metric = make()
        per_metric[label] = {
            "update_ms": wall_ms(torch, lambda m=metric: m.update(p_in, t_in)),
            "forward_ms": wall_ms(torch, lambda m=metric: m(p_in, t_in)),
        }
    metric = MulticlassConfusionMatrix(num_classes=c_ade, ignore_index=-1)
    per_metric["ade20k_confusion_matrix"] = {
        "update_ms": wall_ms(torch, lambda m=metric: m.update(seg_preds[0], seg_target[0])),
    }
    emit({
        "phase": "timing", "shapes": shapes, "wall_ms_per_call": per_metric,
        "ms": "queued_ms, out= the state (device time); call_ms / fresh_call_ms: median_ms, with / without out=",
        "imagenet_val": {"batches_per_s": n_batches / imagenet_s, "samples_per_s": n_val / imagenet_s},
        "ade20k_full": {"updates_per_s": n_updates / ade_s, "pixels_per_s": pixels / ade_s},
        "card": smi,
    })

    phase_confmat_distributions(torch, kernel, dev, gen)

    # ------------------------------------------ image trunks: shapes, kernels
    probe = InceptionFeatureExtractor(feature="2048")  # seeded random weights; shapes only
    calls = inception_conv_calls(probe, torch.zeros((200, 3, 32, 32), dtype=torch.uint8, device=dev))
    check(len(calls) == 94 and sum(map(is_pointwise, calls)) == 40, f"{len(calls)} convs per InceptionV3 forward")
    del probe
    conv_checks = phase_conv_epilogue_vs_plain(torch, ce, calls, dev, gen)
    taps = {net_type: lpips_tap_shapes(torch, dev, net_type, pairs=50, side=256) for net_type in ("alex", "vgg", "squeeze")}
    odd = {"odd": [(3, 5, 7, 35), (2, 9, 9, 5), (7, 3, 3, 1000)], "misaligned": [(4, 15, 15, 384), (2, 31, 31, 64)]}
    head_checks = phase_lpips_head_vs_plain(torch, lh, {**taps, **odd}, dev, gen)

    # ------------------------------------------------------- fid_cifar10_10k
    with tempfile.TemporaryDirectory() as folder:
        fid = phase_fid(torch, np, ce, dev, gen, inception_npz(torch, np, args.seed, folder, dev, gen))
    # ----------------------------------------------------------- lpips_pairs
    lpips = phase_lpips(torch, lh, dev, gen)
    # ---------------------------------------------------------- image_timing
    image = phase_image_timing(torch, ce, lh, calls, taps["alex"], dev, gen, smi)

    # ------------------------------------------------- text: kernels vs plain
    rng = np.random.default_rng(args.seed)
    # WMT16 newstest2016 de-en: 2,999 pairs; wordpiece lengths 10-100, mean ~40, padded to 128
    wmt = token_corpus(np, rng, pairs=2999, width=128, min_len=10, max_len=100, mean_len=40.0,
                       vocab=BERT_BASE["vocab_size"])
    wmt_mask = torch.as_tensor(wmt[1]["attention_mask"], device=dev)
    att_checks = phase_attention_vs_plain(torch, ka, dev, gen, wmt_mask)
    ln_checks = phase_layernorm_vs_plain(torch, ka, dev, gen, rows=wmt[1]["input_ids"].size)
    # ------------------------------------------- bertscore_wmt, infolm_pairs
    with tempfile.TemporaryDirectory() as folder:
        npz = bert_base_npz(torch, np, args.seed, folder)
        bert = phase_bertscore(torch, np, ka, npz, wmt)
        pairs = token_corpus(np, rng, pairs=128, width=64, min_len=10, max_len=64, mean_len=30.0,
                             vocab=BERT_BASE["vocab_size"])
        info = phase_infolm(torch, np, ka, npz, pairs)
    # ----------------------------------------------------------- text_timing
    text = phase_text_timing(torch, ka, dev, gen, wmt_mask, smi)

    # ------------------- detection, iou_panoptic, the text metrics without a model
    # the host references run in worker processes while the card works, and are read at the end
    t_detection = time.perf_counter()
    with ProcessPoolExecutor(max_workers=4, mp_context=multiprocessing.get_context("spawn")) as pool:
        corpora = {"bertscore": wmt, "infolm": pairs}
        text_pending = submit_text_no_model(pool, corpora)
        coco = phase_detection_coco_val(torch, np, dev, gen, pool, smi)
        segm = phase_detection_segm(torch, np, dev, gen, pool)
        emit(phase_detection_stream(torch, dev, gen))
        phase_iou_panoptic(torch, np, dev, gen)
        phase_text_no_model(torch, np, corpora, text_pending)
        finish_detection(coco, segm, t_detection)
    check(not [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "torchmetrics_tpu")],
          "a module of JAX or of the JAX package was imported")

    big = shapes["ade20k_update"]
    image_kernels = [
        ("conv_mm_bias_relu", ":67", fid["launches"]["conv_mm_bias_relu"], conv_checks["worst"]["mm_abs"],
         "torchmetrics_tpu/_kernels/conv_epilogue.py", "conv_epilogue.cu", "one InceptionV3 forward (40 pointwise convs), batch 200, bf16"),
        ("bias_relu", ":96", fid["launches"]["bias_relu"], conv_checks["worst"]["br_abs"],
         "torchmetrics_tpu/_kernels/conv_epilogue.py", "conv_epilogue.cu", "one InceptionV3 forward (54 spatial convs), batch 200, bf16"),
        ("lpips_head", ":60", lpips["launches"], head_checks["max_abs_err"],
         "torchmetrics_tpu/_kernels/lpips_head.py", "lpips_head.cu",
         "one alex LPIPS forward (5 taps), 50 pairs of 256x256, bf16 maps, queued_ms"),
    ]
    text_at = "one bertscore_wmt encoder forward (2999, 128, 768), 12 heads, float32"
    image_kernels += [
        ("attention", ":57", bert["launches"]["attention"] + info["launches"]["attention"], att_checks["max_abs_err"],
         "torchmetrics_tpu/_kernels/attention.py", "attention.cu", text_at + ": 12 launches"),
        ("layernorm_residual", ":141", bert["launches"]["layernorm_residual"] + info["launches"]["layernorm_residual"],
         ln_checks["max_abs_err"], "torchmetrics_tpu/_kernels/attention.py", "layernorm_residual.cu", text_at + ": 24 launches"),
    ]
    timings = {**image, **text}
    print(smi, flush=True)
    emit({"kernels": [{
        "name": "confmat",
        "route": "cuda",
        "source": "torchmetrics_tpu_torch/csrc/confmat.cu",
        "replaces": "torchmetrics_tpu/functional/classification/_pallas_confmat.py:54",
        "launches": imagenet_launches + ade_launches + exact_launches + collection["confmat_launches"]
        + miou_launches + rest_launches,
        "max_abs_err": max_abs_err,
        "ms": big["ms"],
        "plain_ms": big["plain_ms"],
        "bound_ms": big["bound_ms"],
        "bound_by": "bytes",
        "library_ms": big["library_ms"],
        "bound_ms_fresh": big["bound_ms_fresh"],
        "at": f"ade20k_update: ({big['n']}, {big['classes']}) {big['labels']} labels + bool mask, into the state, queued_ms",
    }] + [{
        "name": name,
        "route": "cuda",
        "source": f"torchmetrics_tpu_torch/csrc/{source}",
        "replaces": tpu_file + line,
        "launches": launches,
        "max_abs_err": err,
        "ms": timings[name]["ms"],
        "plain_ms": timings[name]["plain_ms"],
        "bound_ms": timings[name]["bound_ms"],
        "bound_by": timings[name]["bound_by"],
        "library_ms": timings[name]["library_ms"],
        "at": at,
    } for name, line, launches, err, tpu_file, source, at in image_kernels]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": device_name, "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
