"""The stream pool's kernel route on a CUDA card (skipped where there is none).

Kernel B1's lane-batched launch (``confusion_matrix_lanes``) against its
plain version at a pool's micro-batch shapes, once a call; and a pooled
1,000-class confusion matrix on the card: captured into one CUDA graph per
signature and capacity, B1 launched once a micro-batch whatever the number
of lanes, every tenant's matrix equal to the plain version's counts. This
file imports no JAX: run it on the card with
``python -m pytest --noconftest tests/test_torch_streams_card.py``.
"""

import numpy as np
import pytest
import torch

import torchmetrics_tpu_torch as tm
from torchmetrics_tpu_torch import _compile
from torchmetrics_tpu_torch.functional.classification import _confmat_kernel as K


def _card():
    if not torch.cuda.is_available():
        pytest.skip("the lane-batched kernel launches only on a CUDA card")


@pytest.mark.cuda
def test_the_lane_batched_b1_kernel_matches_its_plain_version_on_the_card():
    _card()
    rng = np.random.default_rng(9)
    for lanes, n, c in ((64, 1024, 1000), (3, 1001, 300), (5, 7, 256)):
        preds = torch.from_numpy(rng.integers(-1, c + 1, (lanes, n))).cuda()
        target = torch.from_numpy(rng.integers(-1, c + 1, (lanes, n))).cuda()
        mask = torch.from_numpy(rng.random((lanes, n)) < 0.8).cuda()
        for weights in (None, mask):
            before = int(K.confusion_matrix_lanes.launches)
            got = K.confusion_matrix_lanes(preds, target, c, weights)
            assert int(K.confusion_matrix_lanes.launches) == before + 1
            want = K.confusion_matrix_lanes_plain(preds.cpu(), target.cpu(), c, None if weights is None else weights.cpu())
            assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_a_pooled_confusion_matrix_replays_one_graph_and_launches_b1_once_a_micro_batch():
    _card()
    rng = np.random.default_rng(10)
    c, lanes, rows, steps = 300, 6, 257, 5
    pool = tm.MulticlassConfusionMatrix(num_classes=c, device="cuda").to_stream_pool(capacity=lanes)
    ids = [pool.attach() for _ in range(lanes)]
    preds = torch.from_numpy(rng.integers(0, c, (steps, lanes, rows))).cuda()
    target = torch.from_numpy(rng.integers(0, c, (steps, lanes, rows))).cuda()
    K.confusion_matrix_lanes.launches.reset()
    for s in range(steps):
        pool.update(ids, preds[s], target[s])
    assert int(K.confusion_matrix_lanes.launches) == steps
    assert len(pool._step_fns) == 1 and isinstance(next(iter(pool._step_fns.values())), _compile.CapturedStep)
    got = pool.compute_all()
    for i, sid in enumerate(ids):
        want = K.confusion_matrix_plain(preds[:, i].reshape(-1).cpu(), target[:, i].reshape(-1).cpu(), c)
        assert torch.equal(got[sid].cpu(), want)
