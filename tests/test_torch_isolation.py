"""The port stands alone: no JAX, nothing of ``torchmetrics_tpu``; ``chip_smoke.py`` refuses to run without a GPU."""

import ast
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "torchmetrics_tpu_torch")


def _run(code_or_args, cwd=ROOT, timeout=180):
    args = ["-c", code_or_args] if isinstance(code_or_args, str) else code_or_args
    env = {**os.environ, "PYTHONPATH": ROOT if cwd == ROOT else ""}
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env, capture_output=True, text=True, timeout=timeout)


def test_port_runs_with_jax_and_the_jax_package_blocked():
    code = (
        "import os, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['torchmetrics_tpu'] = None\n"
        "jax_pkg = os.path.join(os.getcwd(), 'torchmetrics_tpu') + os.sep\n"
        "opened = []\n"
        "def audit(event, args):\n"
        "    if event in ('open', 'ctypes.dlopen') and args and isinstance(args[0], (str, bytes)):\n"
        "        path = os.path.abspath(os.fsdecode(args[0]))\n"
        "        if path.startswith(jax_pkg) or '.native_cache' in path:\n"
        "            opened.append(path)\n"
        "sys.addaudithook(audit)\n"
        "import torch\n"
        "import torchmetrics_tpu_torch as tt\n"
        "m = tt.MulticlassConfusionMatrix(num_classes=300, device='cpu')\n"
        "m.update(torch.tensor([1, 2, 299, 7]), torch.tensor([1, 2, 0, 7]))\n"
        "cm = m.compute()\n"
        "assert cm.shape == (300, 300) and int(cm.trace()) == 3 and int(cm[0, 299]) == 1\n"
        "fid = tt.FrechetInceptionDistance(feature=64, device='cpu')\n"
        "fid.update(torch.randint(0, 256, (2, 3, 32, 32), dtype=torch.uint8), real=True)\n"
        "assert float(fid.real_features_num_samples) == 2\n"
        "lp = tt.LearnedPerceptualImagePatchSimilarity(net_type='squeeze', device='cpu')\n"
        "lp.update(torch.rand(2, 3, 32, 32) * 2 - 1, torch.rand(2, 3, 32, 32) * 2 - 1)\n"
        "assert bool(torch.isfinite(lp.compute()))\n"
        "mc = tt.MetricCollection({'acc': tt.MulticlassAccuracy(num_classes=3, device='cpu'),\n"
        "                          'f1': tt.MulticlassF1Score(num_classes=3, device='cpu'),\n"
        "                          'auroc': tt.MulticlassAUROC(num_classes=3, thresholds=5, device='cpu'),\n"
        "                          'roc': tt.MulticlassROC(num_classes=3, device='cpu', cat_state_capacity=8)})\n"
        "out = mc(torch.tensor([[0.8, 0.1, 0.1], [0.2, 0.7, 0.1]]), torch.tensor([0, 2]))\n"
        "assert sorted(out) == ['acc', 'auroc', 'f1', 'roc'] and mc.compute_groups[0] == ['acc', 'f1']\n"
        "rm = tt.RunningMean(window=2, device='cpu')\n"
        "rm.update(1.0); rm.update(3.0); rm.update(5.0)\n"
        "assert float(rm.compute()) == 4.0\n"
        "import os, tempfile, numpy as np\n"
        "from torchmetrics_tpu_torch.text._bert_encoder import BertConfig, BertEncoderExtractor, _BertWithHead, init_bert_weights_\n"
        "from torchmetrics_tpu_torch.utilities.convert import bert_variables_from_state_dict, build_on_cpu\n"
        "cfg = BertConfig(vocab_size=50, hidden_size=32, num_layers=1, num_heads=2, intermediate_size=64, max_position=16)\n"
        "npz = os.path.join(tempfile.mkdtemp(), 'bert.npz')\n"
        "np.savez(npz, **bert_variables_from_state_dict(init_bert_weights_(build_on_cpu(_BertWithHead, cfg), 0).state_dict(), cfg))\n"
        "bs = tt.BERTScore(model=BertEncoderExtractor(npz, device='cpu'), max_length=8, device='cpu')\n"
        "enc = {'input_ids': np.array([[1, 7, 9, 2, 0]]), 'attention_mask': np.array([[1, 1, 1, 1, 0]])}\n"
        "bs.update(enc, enc)\n"
        "assert abs(float(bs.compute()['f1'][0]) - 1.0) < 1e-5\n"
        "hb = tt.BERTScore(device='cpu')\n"
        "hb.update(['the cat sat on the mat'], ['the cat sat on a mat'])\n"
        "assert 0.5 < float(hb.compute()['f1'][0]) < 1.0\n"
        "box = lambda *v: torch.tensor([v], dtype=torch.float32)\n"
        "det = [dict(boxes=box(10, 10, 50, 50), scores=torch.tensor([0.9]), labels=torch.tensor([1]))]\n"
        "gt = [dict(boxes=box(12, 12, 52, 52), labels=torch.tensor([1]))]\n"
        "mp = tt.MeanAveragePrecision(device='cpu')\n"
        "mp.update(det, gt)\n"
        "assert float(mp.compute()['map_50']) == 1.0\n"
        "mp.tm_to_coco(os.path.join(tempfile.mkdtemp(), 'coco'))\n"
        "ms = tt.MeanAveragePrecision(iou_type='segm', device='cpu')\n"
        "mask = torch.zeros((1, 8, 8), dtype=torch.bool); mask[0, 2:6, 2:6] = True\n"
        "ms.update([dict(masks=mask, scores=torch.tensor([0.5]), labels=torch.tensor([0]))], [dict(masks=mask, labels=torch.tensor([0]))])\n"
        "assert float(ms.compute()['map']) == 1.0\n"
        "ms.tm_to_coco(os.path.join(tempfile.mkdtemp(), 'coco'))\n"
        "io = tt.IntersectionOverUnion(device='cpu')\n"
        "io.update(det, gt)\n"
        "assert abs(float(io.compute()['iou']) - 1444 / 1756) < 1e-6\n"
        "pq = tt.PanopticQuality(things={0, 1}, stuffs={6, 7}, device='cpu')\n"
        "pan = torch.tensor([[[[6, 0], [0, 0]], [[0, 0], [1, 0]]]])\n"
        "pq.update(pan, pan)\n"
        "assert float(pq.compute()) == 1.0\n"
        "sn = tt.SignalNoiseRatio(device='cpu')\n"
        "sn.update(torch.tensor([2.5, 0.0, 2.0, 8.0]), torch.tensor([3.0, -0.5, 2.0, 7.0]))\n"
        "assert abs(float(sn.compute()) - 16.1805) < 1e-3\n"
        "sr = tt.SpeechReverberationModulationEnergyRatio(8000, device='cpu')\n"
        "sr.update(torch.randn(2, 4096, generator=torch.Generator().manual_seed(0)))\n"
        "assert bool(torch.isfinite(sr.compute()))\n"
        "cs = tt.CLIPScore(device='cpu')\n"
        "cs.update(torch.rand(2, 3, 32, 32), ['a cat', 'a dog'])\n"
        "assert bool(torch.isfinite(cs.compute()))\n"
        "from torchmetrics_tpu_torch.functional.segmentation import surface_distance\n"
        "sq = torch.zeros(8, 8, dtype=torch.bool); sq[2:6, 2:6] = True\n"
        "assert float(surface_distance(sq, sq).max()) == 0.0\n"
        "assert not opened, opened\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'torchmetrics_tpu.')) for k in sys.modules if sys.modules[k])\n"
        "print('ok')\n"
    )
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def _imported_modules(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def _port_sources():
    for dirpath, _, files in os.walk(PORT):
        yield from (os.path.join(dirpath, f) for f in files if f.endswith(".py"))
    yield os.path.join(ROOT, "chip_smoke.py")


@pytest.mark.parametrize("path", sorted(_port_sources()), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_jax_package_import(path):
    for module in _imported_modules(path):
        top = module.split(".")[0]
        assert top not in ("jax", "jaxlib", "flax", "torchmetrics_tpu"), f"{path} imports {module}"


def test_chip_smoke_fails_without_cuda_and_prints_no_result():
    proc = _run(["chip_smoke.py"])
    assert proc.returncode != 0
    assert proc.stdout == ""


def test_chip_smoke_fails_alone_in_a_directory(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path / "chip_smoke.py")
    proc = _run(["chip_smoke.py"], cwd=str(tmp_path))
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def _package_sources():
    for dirpath, _, files in os.walk(PORT):
        yield from (os.path.join(dirpath, f) for f in files if f.endswith(".py"))


@pytest.mark.parametrize("path", sorted(_package_sources()), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_scipy_or_sklearn_import(path):
    """The package needs neither; ``chip_smoke.py`` may use scipy for its own references."""
    for module in _imported_modules(path):
        assert module.split(".")[0] not in ("scipy", "sklearn"), f"{path} imports {module}"


def test_clustering_nominal_and_wrappers_run_with_scipy_and_sklearn_blocked():
    code = (
        "import sys\n"
        "for name in ('jax', 'torchmetrics_tpu', 'scipy', 'sklearn'):\n"
        "    sys.modules[name] = None\n"
        "import torch\n"
        "import torchmetrics_tpu_torch as tt\n"
        "from torchmetrics_tpu_torch.functional import adjusted_mutual_info_score, calculate_contingency_matrix\n"
        "p, t = torch.tensor([0, 0, 1, 1, 2, 2]), torch.tensor([0, 0, 1, 2, 2, 2])\n"
        "assert 0.0 < float(adjusted_mutual_info_score(p, t)) < 1.0\n"
        "assert calculate_contingency_matrix(p, t, sparse=True).to_dense().sum() == 6\n"
        "cv = tt.CramersV(num_classes=3, device='cpu'); cv.update(p, t)\n"
        "assert 0.0 < float(cv.compute()) <= 1.0\n"
        "bs = tt.BootStrapper(tt.MeanSquaredError(device='cpu'), num_bootstraps=3, seed=0)\n"
        "for _ in range(2): bs.update(p.float(), t.float())\n"
        "assert bs.route_counts == {'loop': 1, 'stacked': 1}\n"
        "print('ok')\n"
    )
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
