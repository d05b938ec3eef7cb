"""The port's panoptic quality (functional and class) on the CPU, against the JAX package.

Seeded ``(B, H, W, 2)`` maps of (category, instance) with things, stuffs,
unknown categories and void go through both packages; results agree within
1e-6, and the class's four sum states exactly (counts) and within 1e-6 (IoU
sums).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu.detection as JD
import torchmetrics_tpu.functional.detection as JF
import torchmetrics_tpu_torch.detection as PD
import torchmetrics_tpu_torch.functional.detection as PF

THINGS, STUFFS = {0, 1, 3}, {6, 7}


def _maps(seed, batch=2, side=16, unknown=True):
    """Blocky maps: 4x4 tiles of a category with a few instances each, so segments overlap partly."""
    rng = np.random.default_rng(seed)
    cats = np.array(sorted(THINGS | STUFFS) + ([255] if unknown else []))
    tiles = side // 4

    def one():
        cat = np.kron(rng.choice(cats, (batch, tiles, tiles)), np.ones((4, 4), int))
        inst = np.kron(rng.integers(0, 3, (batch, tiles, tiles)), np.ones((4, 4), int))
        return np.stack([cat, inst], -1)

    preds, target = one(), one()
    agree = rng.random((batch, side, side)) < 0.6
    preds[agree] = target[agree]
    return preds, target


@pytest.mark.parametrize("name", ["panoptic_quality", "modified_panoptic_quality"])
@pytest.mark.parametrize("seed", range(3))
def test_functional_matches_jax(name, seed):
    preds, target = _maps(seed)
    kw = dict(things=THINGS, stuffs=STUFFS, allow_unknown_preds_category=True)
    want = getattr(JF, name)(jnp.asarray(preds), jnp.asarray(target), **kw)
    got = getattr(PF, name)(torch.from_numpy(preds), torch.from_numpy(target), **kw)
    np.testing.assert_allclose(float(got), float(want), rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", ["PanopticQuality", "ModifiedPanopticQuality"])
def test_class_states_match_jax(name):
    jm = getattr(JD, name)(things=THINGS, stuffs=STUFFS, allow_unknown_preds_category=True)
    pm = getattr(PD, name)(things=THINGS, stuffs=STUFFS, allow_unknown_preds_category=True, device="cpu")
    for seed in (10, 11):
        preds, target = _maps(seed, batch=3)
        jm.update(jnp.asarray(preds), jnp.asarray(target))
        pm.update(torch.from_numpy(preds), torch.from_numpy(target))
    for state in ("true_positives", "false_positives", "false_negatives"):
        np.testing.assert_array_equal(getattr(pm, state).numpy(), np.asarray(getattr(jm, state)), err_msg=state)
    np.testing.assert_allclose(pm.iou_sum.numpy(), np.asarray(jm.iou_sum), rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(pm.compute()), float(jm.compute()), rtol=0, atol=1e-6)


def test_unknown_categories_and_bad_inputs_raise():
    preds, target = _maps(0)
    with pytest.raises(ValueError, match="Unknown categories"):
        PF.panoptic_quality(torch.from_numpy(preds), torch.from_numpy(target), things=THINGS, stuffs=STUFFS)
    with pytest.raises(ValueError, match="distinct"):
        PD.PanopticQuality(things={0, 1}, stuffs={1}, device="cpu")
    with pytest.raises(ValueError, match="same shape"):
        PF.panoptic_quality(torch.zeros((1, 4, 4, 2)), torch.zeros((1, 4, 5, 2)), things={0}, stuffs={1})
    with pytest.raises(ValueError, match="2 channels"):
        PF.panoptic_quality(torch.zeros((1, 4, 4, 3)), torch.zeros((1, 4, 4, 3)), things={0}, stuffs={1})


def test_negative_and_large_ids_match_jax():
    """Colours are packed into one int64 key per pixel: the order must stay (category, instance) for any int32 ids."""
    rng = np.random.default_rng(3)
    things, stuffs = {-5, 0, 70000}, {2**30}
    cats = np.array(sorted(things | stuffs))
    preds = np.stack([rng.choice(cats, (2, 8, 8)), rng.choice([-(2**31), -1, 0, 2**31 - 1], (2, 8, 8))], -1)
    target = preds.copy()
    swap = rng.random((2, 8, 8)) < 0.3
    target[swap] = np.stack([rng.choice(cats, int(swap.sum())), rng.choice([-1, 7], int(swap.sum()))], -1)
    for name in ("panoptic_quality", "modified_panoptic_quality"):
        want = getattr(JF, name)(jnp.asarray(preds), jnp.asarray(target), things=things, stuffs=stuffs)
        got = getattr(PF, name)(torch.from_numpy(preds), torch.from_numpy(target), things=things, stuffs=stuffs)
        np.testing.assert_allclose(float(got), float(want), rtol=0, atol=1e-6)
