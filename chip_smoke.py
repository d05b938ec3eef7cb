#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one GPU and hold each kernel against its plain version.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card and ``nvcc``; it builds the five kernel libraries of
``torchmetrics_tpu_torch/csrc/`` (one ``nvcc`` each, started together). It
exits non-zero, printing no result, where ``torch.cuda.is_available()`` is
false or the package is not beside it.

Phases, one JSON line each; any mismatch raises and the script exits non-zero:

1. ``build``: compile the five kernel libraries (the build line gives each library's
   ``nvcc`` time, kernel count, most registers and largest spill, and, for the
   kernels redesigned for Hopper, each one's registers, spills and dynamic shared
   memory), print the card's name and power limit;
2. ``kernel_vs_plain``: the confmat kernel against its plain PyTorch version on the card,
   counts exactly, float32 weights within a stated tolerance;
3. ``imagenet_val``: torchvision's classification evaluation (50,000 samples,
   1000 classes, batches of 1024) through ``MulticlassAccuracy`` top-1/top-5
   and ``MulticlassConfusionMatrix``, half by ``forward``, half by ``update``,
   checked exactly against ``numpy`` on the host;
4. ``ade20k_full``: 847-class semantic segmentation, 8 updates of 16 label maps
   of 512x512 with void pixels under ``ignore_index=-1``, checked exactly
   against the plain version on the card;
5. ``timing``: CUDA-event medians of the confmat kernel, its plain version and
   ``torch.bincount`` at the main path's two shapes, beside the bytes bound;
6. ``conv_epilogue_vs_plain``: kernels B2a (GEMM + bias + ReLU) and B2b
   (bias + ReLU) against their plain versions at every distinct shape of one
   InceptionV3 forward at batch 200, bf16 and float32, plus odd tails;
7. ``lpips_head_vs_plain``: kernel B3 at every tap shape of the alex, vgg and
   squeeze trunks at 256x256, 50 pairs;
8. ``fid_cifar10_10k``: ``FrechetInceptionDistance(feature=2048)`` over 10,000
   real and 10,000 perturbed uint8 3x32x32 images in updates of 200, launch
   counts exact, the bf16 fused trunk against the float32 unfused one, the
   FID against a float64 host recomputation from the metric's states;
9. ``lpips_pairs``: ``LearnedPerceptualImagePatchSimilarity()`` (alex) over
   1,000 pairs of 3x256x256 images in batches of 50, one batch each of vgg
   and squeeze, launch counts exact, against ``LPIPSNet(unfused=True)``.
   Phases 8 and 9 also give one update's device time by kernel
   (``torch.profiler``) and the share of its wall time the card sat idle;
10. ``image_timing``: CUDA-event medians of B2a, B2b and B3 at their main-path
    shapes, beside their bounds, plain versions and library calls, summed over
    one forward, and B2a by activation size (73x73, 35x35, 17x17, 8x8);
11. ``attention_vs_plain``: kernel B4 (masked attention) against its plain version
    at the path's shapes, (2999, 128, 768)/12 heads of ``compute`` and
    (100, 128, 768) of a ``forward``, with the WMT corpus's ragged masks, at
    L 1, 37 and 509, at hidden 96/4 heads, with fully masked rows, float32
    and bf16; a view that is not 4-element aligned is refused;
12. ``layernorm_residual_vs_plain``: kernel B5 at the path's (383872, 768) and at
    C 70, 1000, 1024 and 2000, float32, bf16 and mixed inputs;
13. ``bertscore_wmt``: ``BERTScore(model=BertEncoderExtractor(npz))`` on seeded
    random bert-base-uncased weights over 2,999 pre-tokenized pairs (the size of
    WMT16 newstest2016 de-en) in updates of 100, half by ``forward``, then
    ``compute``, with ``idf`` off and on: launch counts exact, scores against the
    unfused float32 encoder on the card, one ``compute``'s device time by kernel;
14. ``infolm_pairs``: ``InfoLM`` (KL, idf, temperature 0.25) on the same weights'
    MLM head over 128 pairs of up to 64 wordpieces, launch counts exact, against
    the unfused MLM on the card;
15. ``text_timing``: CUDA-event medians of B4 and B5 at one BERTScore encoder
    forward's shapes, beside their bounds, plain versions and library calls, and
    of B4 on bf16 inputs beside bf16 ``scaled_dot_product_attention``;

then the card's name and power limit, the ``kernels`` line and, last,
``{"ok": true, "device": {...}}``. Trunk weights are seeded random ones: no
checkpoint can be downloaded.
"""

from __future__ import annotations

import argparse
import collections
import importlib
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory, NVIDIA data sheet
FLOAT_RTOL = 1e-4  # float32 cell sums of up to ~1000 weights, atomics vs blocked GEMM order: k * 2**-24 ~ 6e-5
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


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


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


def ptxas_kernels(log: str, pattern: str) -> dict:
    """Registers and spill bytes of each kernel whose mangled name matches ``pattern`` (``Name<arg>``), from ptxas -v."""
    found, name = {}, None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            short = re.search(pattern + r"ILi(\d+)E", entry.group(1))
            name = f"{short.group(1)}<{short.group(2)}>" if short else None
            continue
        if name is not None:
            spill = re.search(r"(\d+) bytes spill stores", line)
            regs = re.search(r"Used (\d+) registers", line)
            if spill:
                found.setdefault(name, {})["spill_bytes"] = int(spill.group(1))
            if regs:
                found.setdefault(name, {})["registers"] = int(regs.group(1))
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
    cases, worst_rel, worst_abs = 0, 0.0, 0.0
    for net_type, shapes in tap_shapes.items():
        for shape in shapes:
            f0 = torch.randn(shape, generator=gen, device=dev).relu_()
            f1 = (f0 + 0.3 * torch.randn(shape, generator=gen, device=dev)).relu_()
            w = torch.rand(shape[-1], generator=gen, device=dev)
            got = lh.lpips_head(f0, f1, w)
            ref = lh.lpips_head_plain(f0, f1, w)
            torch.cuda.synchronize()
            err = (got - ref).abs()
            rel = float((err / ref.abs()).max())
            name = f"B3 {net_type} {shape}"
            check(bool((err <= HEAD_RTOL * ref.abs() + 1e-7).all()), f"{name}: max rel err {rel}")
            worst_rel, worst_abs = max(worst_rel, rel), max(worst_abs, float(err.max()))
            cases += 1
    emit({
        "phase": "lpips_head_vs_plain", "cases": cases, "max_rel_err": worst_rel, "max_abs_err": worst_abs,
        "tolerance": f"|err| <= {HEAD_RTOL} * |ref| + 1e-7 (the JAX package's rtol)",
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
    result = {
        "phase": "lpips_pairs", "pairs": n_pairs, "batch": batch, "net_type": "alex", "lpips": float(score),
        "unfused_mean": oracle_sum / n_pairs, "rel_err": abs(got_sum - oracle_sum) / abs(oracle_sum),
        "launches": launches, "seconds": seconds, "pairs_per_s": n_pairs / seconds, "peak_mem_bytes": peak,
        "update_profile": profile, "others": {},
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
    for shape in lpips_taps:
        f0 = torch.randn(shape, generator=gen, device=dev).relu_()
        f1 = (f0 + 0.3 * torch.randn(shape, generator=gen, device=dev)).relu_()
        w = torch.rand(shape[-1], generator=gen, device=dev)
        bound, by = bound_ms(lh.lpips_head_cost(f0, f1, w), F32_FLOPS_PER_S)
        rows["lpips_head"].append({
            "shape": list(shape), "count": 1, "bound_ms": bound, "bound_by": by,
            "ms": median_ms(torch, lambda: lh.lpips_head(f0, f1, w), reps=30),
            "plain_ms": median_ms(torch, lambda: lh.lpips_head_plain(f0, f1, w), reps=10),
            "library_ms": None,
        })
    totals = {}
    for name, kernel_rows in rows.items():
        total = {key: sum(r[key] * r["count"] for r in kernel_rows) for key in ("ms", "plain_ms", "bound_ms")}
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
    emit({"phase": "image_timing", "per_forward": totals, "conv_mm_bias_relu_by_group": groups, "card": smi,
          "at": {"conv": "one InceptionV3 forward, batch 200, bf16", "lpips_head": "one alex LPIPS forward, 50 pairs of 256x256"}})
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
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version's one-hot products stay in full float32
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
    redesigned = ptxas_kernels(infos["conv_epilogue"]["log"], "(mm_bias_relu_tma)")
    for key, value in redesigned.items():
        value["smem_bytes"] = ce._library().tm_mm_bias_relu_tma_smem(int(key.split("<")[1][:-1]))
    for key, value in ptxas_kernels(infos["attention"]["log"], "(attention_tf32x3|attention_bf16)").items():
        value["smem_bytes"] = ka._attention_library().tm_attention_smem(int("bf16" in key), int(key.split("<")[1][:-1]))
        redesigned[key] = value
    emit({
        "phase": "build",
        "seconds": round(time.perf_counter() - t0, 3),
        "libraries": {
            name: {"nvcc_seconds": round(info["seconds"], 3), "built": info["built"], **ptxas_summary(info["log"])}
            for name, info in infos.items()
        },
        "redesigned_kernels": redesigned,
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
    ]
    max_abs_err = 0.0
    for n, c, dtype, wkind, labels in cases:
        lo, hi = (-2, c + 2) if labels == "out_of_range" else (0, c)
        t = torch.randint(lo, hi, (n,), generator=gen, device=dev, dtype=dtype)
        p = t.clone() if labels == "diagonal" else torch.randint(lo, hi, (n,), generator=gen, device=dev, dtype=dtype)
        w = None
        if wkind == "mask":
            w = torch.rand(n, generator=gen, device=dev) < 0.9
        elif wkind == "float":
            w = torch.rand(n, generator=gen, device=dev)
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
        nbytes = n * (2 * p.element_size() + valid.element_size()) + c * c * 4
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        ms = median_ms(torch, lambda: confmat_cuda(p, t, c, valid), reps=50)
        shapes[name] = {
            "n": n, "classes": c, "labels": str(p.dtype).split(".")[-1], "weights": "bool mask",
            "ms": ms,
            "bound_ms": bound,
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
        "imagenet_val": {"batches_per_s": n_batches / imagenet_s, "samples_per_s": n_val / imagenet_s},
        "ade20k_full": {"updates_per_s": n_updates / ade_s, "pixels_per_s": pixels / ade_s},
        "card": smi,
    })

    # ------------------------------------------ image trunks: shapes, kernels
    probe = InceptionFeatureExtractor(feature="2048")  # seeded random weights; shapes only
    calls = inception_conv_calls(probe, torch.zeros((200, 3, 32, 32), dtype=torch.uint8, device=dev))
    check(len(calls) == 94 and sum(map(is_pointwise, calls)) == 40, f"{len(calls)} convs per InceptionV3 forward")
    del probe
    conv_checks = phase_conv_epilogue_vs_plain(torch, ce, calls, dev, gen)
    taps = {net_type: lpips_tap_shapes(torch, dev, net_type, pairs=50, side=256) for net_type in ("alex", "vgg", "squeeze")}
    head_checks = phase_lpips_head_vs_plain(torch, lh, taps, dev, gen)

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

    big = shapes["ade20k_update"]
    image_kernels = [
        ("conv_mm_bias_relu", ":67", fid["launches"]["conv_mm_bias_relu"], conv_checks["worst"]["mm_abs"],
         "torchmetrics_tpu/_kernels/conv_epilogue.py", "conv_epilogue.cu", "one InceptionV3 forward (40 pointwise convs), batch 200, bf16"),
        ("bias_relu", ":96", fid["launches"]["bias_relu"], conv_checks["worst"]["br_abs"],
         "torchmetrics_tpu/_kernels/conv_epilogue.py", "conv_epilogue.cu", "one InceptionV3 forward (54 spatial convs), batch 200, bf16"),
        ("lpips_head", ":60", lpips["launches"], head_checks["max_abs_err"],
         "torchmetrics_tpu/_kernels/lpips_head.py", "lpips_head.cu", "one alex LPIPS forward (5 taps), 50 pairs of 256x256"),
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
        "launches": imagenet_launches + ade_launches,
        "max_abs_err": max_abs_err,
        "ms": big["ms"],
        "plain_ms": big["plain_ms"],
        "bound_ms": big["bound_ms"],
        "bound_by": "bytes",
        "library_ms": big["library_ms"],
        "at": f"ade20k_update: ({big['n']}, {big['classes']}) {big['labels']} labels + bool mask",
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
