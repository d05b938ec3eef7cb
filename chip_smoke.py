#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and hold its kernel against its plain version.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card and ``nvcc``; it builds ``torchmetrics_tpu_torch/csrc/confmat.cu``
at first use. It exits non-zero, printing no result, where
``torch.cuda.is_available()`` is false or the package is not beside it.

Phases, one JSON line each; any mismatch raises and the script exits non-zero:

1. ``build``: compile the confmat kernel, print the card's name and power limit;
2. ``kernel_vs_plain``: the kernel against its plain PyTorch version on the card,
   counts exactly, float32 weights within a stated tolerance;
3. ``imagenet_val``: torchvision's classification evaluation (50,000 samples,
   1000 classes, batches of 1024) through ``MulticlassAccuracy`` top-1/top-5
   and ``MulticlassConfusionMatrix``, half by ``forward``, half by ``update``,
   checked exactly against ``numpy`` on the host;
4. ``ade20k_full``: 847-class semantic segmentation, 8 updates of 16 label maps
   of 512x512 with void pixels under ``ignore_index=-1``, checked exactly
   against the plain version on the card;
5. ``timing``: CUDA-event medians of the kernel, its plain version and
   ``torch.bincount`` at the main path's two shapes, beside the bytes bound;

then the ``kernels`` line and, last, ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory, NVIDIA data sheet
FLOAT_RTOL = 1e-4  # float32 cell sums of up to ~1000 weights, atomics vs blocked GEMM order: k * 2**-24 ~ 6e-5
FLOAT_ATOL = 1e-4


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

    confmat_cuda, confmat_plain = kernel.confusion_matrix_cuda, kernel.confusion_matrix_plain
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version's one-hot products stay in full float32
    device_name = torch.cuda.get_device_name(0)

    # ------------------------------------------------------------------ build
    t0 = time.perf_counter()
    info = kernel.build()
    kernel._library()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    emit({
        "phase": "build",
        "seconds": round(time.perf_counter() - t0, 3),
        "nvcc_seconds": round(info["seconds"], 3),
        "built": info["built"],
        "ptxas": [ln.strip() for ln in info["log"].splitlines() if "registers" in ln or "spill" in ln],
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

    big = shapes["ade20k_update"]
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
    }]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": device_name, "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
