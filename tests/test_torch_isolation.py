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
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['torchmetrics_tpu'] = None\n"
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
