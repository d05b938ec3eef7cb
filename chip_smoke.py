#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one GPU and hold each kernel against its plain version.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card and ``nvcc``; it builds the three kernel libraries of
``torchmetrics_tpu_torch/csrc/`` (one ``nvcc`` each, started together). It
exits non-zero, printing no result, where ``torch.cuda.is_available()`` is
false or the package is not beside it.

Phases, one JSON line each; any mismatch raises and the script exits non-zero:

1. ``build``: compile the three kernel libraries, print the card's name and power limit;
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
    shapes, beside their bounds, plain versions and library calls, per shape
    and summed over one forward;

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
GEMM_F32_RTOL = 1e-5  # of the output's scale: float32 sums of up to 2048 products, in another order
GEMM_BF16_ULP = 2.0**-7  # of each value: the float32 sums differ, so one bf16 rounding may flip
HEAD_RTOL = 1e-5  # the JAX package's own tolerance for the LPIPS head
TRUNK_F32_RTOL = 1e-3  # fused (kernels) vs unfused float32 trunk, by relative norm; the chaos below grows f32 roundings too
# bf16 fused trunk vs float32 unfused trunk, by relative norm. With calibrated BatchNorm a random
# InceptionV3 is chaotic: BN + ReLU grows a relative perturbation ~1.2x per layer, so bf16's 2**-9
# roundings reach ~0.2 at the 2048 tap. Wrong weights or a wrong layout give ~1.
TRUNK_BF16_RTOL = 0.5
FID_RTOL = 1e-2  # the metric's float32 FID vs a float64 host recomputation from its own states


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
        "top": [{"kernel": name[:90], "ms": ms, "calls": calls} for name, ms, calls in rows[:top]],
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
    from torchmetrics_tpu_torch.image._inception import InceptionV3, _BatchNorm, _resize_bilinear_tf1, build_on_cpu, init_weights_
    from torchmetrics_tpu_torch.utilities.compute import full_fp32
    from torchmetrics_tpu_torch.utilities.convert import variables_from_state_dict

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
    # odd tails: element path (K or N not a multiple of 8) and the 16-byte path with ragged M and N
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
    from torchmetrics_tpu_torch.image._inception import build_on_cpu, init_weights_
    from torchmetrics_tpu_torch.image._lpips import LPIPSNet

    trunk = init_weights_(build_on_cpu(LPIPSNet, net_type=net_type, dtype=torch.bfloat16), 0).net
    trunk = trunk.to(device=dev, memory_format=torch.channels_last)
    x = torch.zeros((2 * pairs, 3, side, side), device=dev).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        return [(pairs, f.shape[2], f.shape[3], f.shape[1]) for f in trunk(x)]


def phase_lpips_head_vs_plain(torch, lh, tap_shapes: dict, dev, gen) -> dict:
    cases, worst_rel, worst_abs = [], 0.0, 0.0
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
            cases.append({"case": name, "max_rel_err": rel})
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
            "shape": [m, k, n], "count": count, "bound_ms": bound, "bound_by": by,
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
    emit({"phase": "image_timing", "per_forward": totals, "card": smi,
          "at": {"conv": "one InceptionV3 forward, batch 200, bf16", "lpips_head": "one alex LPIPS forward, 50 pairs of 256x256"},
          "rows": rows})
    return totals


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
    confmat_cuda, confmat_plain = kernel.confusion_matrix_cuda, kernel.confusion_matrix_plain
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version's one-hot products stay in full float32
    device_name = torch.cuda.get_device_name(0)

    # ------------------------------------------------------------------ build
    t0 = time.perf_counter()
    modules = {"confmat": kernel, "conv_epilogue": ce, "lpips_head": lh}
    infos = dict(zip(modules, nvcc.build_all([m.SOURCE for m in modules.values()])))  # one nvcc each, at once
    for module in modules.values():
        module._library()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    emit({
        "phase": "build",
        "seconds": round(time.perf_counter() - t0, 3),
        "libraries": {
            name: {
                "nvcc_seconds": round(info["seconds"], 3),
                "built": info["built"],
                "ptxas": [ln.strip() for ln in info["log"].splitlines() if "registers" in ln or "spill" in ln],
            }
            for name, info in infos.items()
        },
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
    results = []
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
        results.append({"case": case, "max_abs_err": err})
    emit({
        "phase": "kernel_vs_plain", "cases": results, "max_abs_err": max_abs_err,
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

    big = shapes["ade20k_update"]
    image_kernels = [
        ("conv_mm_bias_relu", ":67", fid["launches"]["conv_mm_bias_relu"], conv_checks["worst"]["mm_abs"],
         "torchmetrics_tpu/_kernels/conv_epilogue.py", "conv_epilogue.cu", "one InceptionV3 forward (40 pointwise convs), batch 200, bf16"),
        ("bias_relu", ":96", fid["launches"]["bias_relu"], conv_checks["worst"]["br_abs"],
         "torchmetrics_tpu/_kernels/conv_epilogue.py", "conv_epilogue.cu", "one InceptionV3 forward (54 spatial convs), batch 200, bf16"),
        ("lpips_head", ":60", lpips["launches"], head_checks["max_abs_err"],
         "torchmetrics_tpu/_kernels/lpips_head.py", "lpips_head.cu", "one alex LPIPS forward (5 taps), 50 pairs of 256x256"),
    ]
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
        "ms": image[name]["ms"],
        "plain_ms": image[name]["plain_ms"],
        "bound_ms": image[name]["bound_ms"],
        "bound_by": image[name]["bound_by"],
        "library_ms": image[name]["library_ms"],
        "at": at,
    } for name, line, launches, err, tpu_file, source, at in image_kernels]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": device_name, "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
