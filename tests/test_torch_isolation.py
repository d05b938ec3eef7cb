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


def test_serving_and_plotting_run_with_jax_and_the_jax_package_blocked():
    """``_serving`` and ``plot`` stand alone; importing the package imports no matplotlib."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['torchmetrics_tpu'] = None\n"
        "import numpy as np, torch\n"
        "import torchmetrics_tpu_torch as tt\n"
        "from torchmetrics_tpu_torch._serving import ControllerConfig, MetricServer, run_serving_chaos\n"
        "assert not [m for m in sys.modules if m.split('.')[0] == 'matplotlib']\n"
        "srv = MetricServer(tt.MulticlassConfusionMatrix(num_classes=5, ignore_index=-1, device='cpu'), capacity=4,\n"
        "                   controller=ControllerConfig(max_batch=4))\n"
        "sids = [srv.attach_stream() for _ in range(3)]\n"
        "assert srv.warm(np.zeros(8, np.int64), np.zeros(8, np.int64))['4:stream_step'] == 'compiled'\n"
        "with srv:\n"
        "    acks = [srv.submit(s, torch.arange(8) % 5, np.full(8, s, np.int64)) for s in sids]\n"
        "    assert [a.result(30) for a in acks] == ['acked'] * 3\n"
        "    assert all(int(srv.compute(s)[s].sum()) == 8 for s in sids)\n"
        "assert run_serving_chaos(0, device='cpu').ok\n"
        "import matplotlib\n"
        "matplotlib.use('Agg')\n"
        "fig, ax = tt.BinaryROC(thresholds=5, device='cpu').plot(curve=(torch.linspace(0, 1, 5), torch.linspace(0, 1, 5), None))\n"
        "assert len(ax.lines) == 1\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'torchmetrics_tpu.')) for k in sys.modules if sys.modules[k])\n"
        "print('ok')\n"
    )
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_fleet_runs_with_jax_and_the_jax_package_blocked():
    """``_fleet`` stands alone: a chaos run, a tree over a ``TCPStore`` and the wire, without JAX."""
    code = (
        "import sys, warnings\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['torchmetrics_tpu'] = None\n"
        "warnings.simplefilter('ignore')\n"
        "import numpy as np, torch, torch.distributed as dist\n"
        "import torchmetrics_tpu_torch as tt\n"
        "from torchmetrics_tpu_torch._fleet import (CoordinationServiceKV, FleetChaosSpec, FleetTree,\n"
        "    decode_contribution, encode_contribution, run_fleet_chaos)\n"
        "spec = FleetChaosSpec(branching=(2, 2), rows_per_epoch=1, deadline_s=0.25)\n"
        "assert run_fleet_chaos(tt.MeanMetric(device='cpu'), lambda rng: (float(rng.uniform()),), spec).ok\n"
        "store = dist.TCPStore('127.0.0.1', 0, 1, True, wait_for_workers=False)\n"
        "tree = FleetTree.build(tt.MulticlassConfusionMatrix(num_classes=5, device='cpu'), (2, 2),\n"
        "                       kv=CoordinationServiceKV(store=store, poll_s=0.005))\n"
        "for leaf in tree.leaves:\n"
        "    leaf.update(torch.arange(8) % 5, torch.arange(8) % 5)\n"
        "assert not tree.run_epoch(0).partial\n"
        "tree.join_pending(5.0)\n"
        "assert int(tree.root.metric.confmat.trace()) == 32\n"
        "blob, _ = encode_contribution(tree.root.metric, 'global', 0, ())\n"
        "assert int(decode_contribution(blob).states['confmat'].sum()) == 32\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'torchmetrics_tpu.')) for k in sys.modules if sys.modules[k])\n"
        "print('ok')\n"
    )
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def _analysis_sources():
    directory = os.path.join(PORT, "_analysis")
    return sorted(os.path.join(directory, f) for f in os.listdir(directory) if f.endswith(".py"))


@pytest.mark.parametrize("path", _analysis_sources(), ids=os.path.basename)
def test_the_analysis_package_imports_the_standard_library_only(path):
    """At import it parses what it scans and never imports it: no torch, no numpy, nothing of the package outside
    ``_analysis`` (the sanitizer's switch reaches the runtime singletons with imports inside the function)."""
    tree = ast.parse(open(path).read(), filename=path)
    for node in tree.body:
        if isinstance(node, ast.Import):
            modules = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom):
            modules = [node.module or ""]
        else:
            continue
        for module in modules:
            top = module.split(".")[0]
            assert module.startswith("torchmetrics_tpu_torch._analysis") or top in sys.stdlib_module_names, (
                f"{path} imports {module}"
            )


def test_the_ports_lint_runs_with_jax_and_the_jax_package_blocked():
    """``python -m torchmetrics_tpu_torch._analysis`` scans the port's tree clean and reads nothing of the JAX package."""
    code = (
        "import os, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['torchmetrics_tpu'] = None\n"
        "jax_pkg = os.path.join(os.getcwd(), 'torchmetrics_tpu') + os.sep\n"
        "opened = []\n"
        "def audit(event, args):\n"
        "    if event == 'open' and args and isinstance(args[0], (str, bytes)):\n"
        "        path = os.path.abspath(os.fsdecode(args[0]))\n"
        "        if path.startswith(jax_pkg):\n"
        "            opened.append(path)\n"
        "sys.addaudithook(audit)\n"
        "from torchmetrics_tpu_torch._analysis.__main__ import main\n"
        "assert main(['torchmetrics_tpu_torch/']) == 0\n"
        "assert not opened, opened[:3]\n"
        "print('ok')\n"
    )
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "ok"


def test_aot_cache_runs_with_jax_and_the_jax_package_blocked(tmp_path):
    """``_aot`` stands alone: a record written then hit, the CLI's ``verify`` and the golden gate, without JAX."""
    code = (
        "import sys, warnings\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['torchmetrics_tpu'] = None\n"
        "warnings.simplefilter('ignore')\n"
        "import torch\n"
        "import torchmetrics_tpu_torch as tt\n"
        "from torchmetrics_tpu_torch._aot import __main__ as cli, aot_stats\n"
        f"tt.set_aot_cache({str(tmp_path)!r})\n"
        "x = torch.linspace(0, 1, 32)\n"
        "for _ in range(2):\n"
        "    assert tt.MeanSquaredError(device='cpu').precompile(x, x.flip(0))['engaged']\n"
        "assert aot_stats()['hits'] == 1 and aot_stats()['writes'] == 1\n"
        f"assert cli.main(['verify', '--dir', {str(tmp_path)!r}]) == 0\n"
        "assert cli.main(['golden']) == 0\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'torchmetrics_tpu.')) for k in sys.modules if sys.modules[k])\n"
        "print('ok')\n"
    )
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "ok"


def test_compile_path_runs_with_jax_and_the_jax_package_blocked():
    """``_compile.py`` and the eligibility copy stand alone: the JAX package's ``eligibility.json`` is never opened."""
    code = (
        "import json, os, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['torchmetrics_tpu'] = None\n"
        "jax_pkg = os.path.join(os.getcwd(), 'torchmetrics_tpu') + os.sep\n"
        "opened = []\n"
        "def audit(event, args):\n"
        "    if event == 'open' and args and isinstance(args[0], (str, bytes)):\n"
        "        path = os.path.abspath(os.fsdecode(args[0]))\n"
        "        if path.startswith(jax_pkg):\n"
        "            opened.append(path)\n"
        "sys.addaudithook(audit)\n"
        "import torch\n"
        "import torchmetrics_tpu_torch as tt\n"
        "from torchmetrics_tpu_torch import _compile\n"
        "assert _compile.eligibility_verdict(tt.MulticlassConfusionMatrix) == 'metadata_only'\n"
        "assert _compile.eligibility_verdict(tt.MulticlassAccuracy) == 'value_flags'\n"
        "copy = json.load(open(_compile._ELIGIBILITY_PATH))['classes']\n"
        "assert len(copy) == 204 and all(k.startswith('torchmetrics_tpu_torch.') for k in copy)\n"
        "m = tt.MulticlassAccuracy(num_classes=3, average='micro', device='cpu')\n"
        "p, t = torch.tensor([[0.8, 0.1, 0.1], [0.2, 0.7, 0.1]]), torch.tensor([0, 2])\n"
        "assert m.precompile(p, t) == {'engaged': True, 'reason': None}\n"
        "m.update(p, t); m.update(p, t); m(p, t); m(p, t)\n"
        "m.jit_update(p, t); m.scan_update(p[None], t[None])\n"
        "assert m.update_count == 6 and abs(float(m.compute()) - 0.5) < 1e-6\n"
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
