"""The port's exports equal the JAX package's, domain by domain, and the top level lacks only what is not ported yet.

The JAX package's ``__all__`` lists are read from its source with ``ast``, so
nothing of it is imported next to the port here.
"""

import ast
import os

import pytest

import torchmetrics_tpu_torch
import torchmetrics_tpu_torch.audio as TA
import torchmetrics_tpu_torch.classification as TC
import torchmetrics_tpu_torch.clustering as TCL
import torchmetrics_tpu_torch.functional as TF_ALL
import torchmetrics_tpu_torch.functional.audio as TFA
import torchmetrics_tpu_torch.functional.classification as TF
import torchmetrics_tpu_torch.functional.clustering as TFCL
import torchmetrics_tpu_torch.functional.image as TFI
import torchmetrics_tpu_torch.functional.multimodal as TFM
import torchmetrics_tpu_torch.functional.nominal as TFN
import torchmetrics_tpu_torch.functional.text as TFT
import torchmetrics_tpu_torch.functional.pairwise as TFP
import torchmetrics_tpu_torch.functional.regression as TFR
import torchmetrics_tpu_torch.functional.retrieval as TFRET
import torchmetrics_tpu_torch.functional.segmentation as TFS
import torchmetrics_tpu_torch.image as TI
import torchmetrics_tpu_torch.multimodal as TM
import torchmetrics_tpu_torch.nominal as TN
import torchmetrics_tpu_torch.regression as TR
import torchmetrics_tpu_torch.retrieval as TRET
import torchmetrics_tpu_torch.text as TT
import torchmetrics_tpu_torch.utilities as TU
import torchmetrics_tpu_torch.wrappers as TW

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_all(relpath):
    with open(os.path.join(ROOT, "torchmetrics_tpu", relpath)) as fh:
        tree = ast.parse(fh.read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(getattr(t, "id", None) == "__all__" for t in node.targets):
            return ast.literal_eval(node.value)
    raise AssertionError(f"no literal __all__ in {relpath}")


@pytest.mark.parametrize(
    ("relpath", "module", "count"),
    [("classification/__init__.py", TC, 94), ("functional/classification/__init__.py", TF, 96)],
)
def test_classification_all_equals_the_jax_package(relpath, module, count):
    want = _jax_all(relpath)
    assert len(want) == count
    assert sorted(module.__all__) == sorted(want)
    missing = [name for name in want if not hasattr(module, name)]
    assert not missing, missing


def test_classification_names_reach_the_top_level():
    assert set(TC.__all__) <= set(torchmetrics_tpu_torch.__all__)
    assert set(TF.__all__) <= set(TF_ALL.__all__)
    for name in TC.__all__:
        assert getattr(torchmetrics_tpu_torch, name) is getattr(TC, name)
    for name in TF.__all__:
        assert getattr(TF_ALL, name) is getattr(TF, name)


@pytest.mark.parametrize(("relpath", "module"), [("text/__init__.py", TT), ("functional/text/__init__.py", TFT)])
def test_text_all_equals_the_jax_package(relpath, module):
    want = _jax_all(relpath)
    assert len(want) == 16
    assert sorted(module.__all__) == sorted(want)
    assert not [name for name in want if not hasattr(module, name)]


def test_text_names_reach_the_top_level():
    for name in TT.__all__:
        assert name in torchmetrics_tpu_torch.__all__ and getattr(torchmetrics_tpu_torch, name) is getattr(TT, name)
    for name in TFT.__all__:
        assert name in TF_ALL.__all__ and getattr(TF_ALL, name) is getattr(TFT, name)


@pytest.mark.parametrize(
    ("relpath", "module", "count"), [("image/__init__.py", TI, 21), ("functional/image/__init__.py", TFI, 18)]
)
def test_image_all_equals_the_jax_package(relpath, module, count):
    want = _jax_all(relpath)
    assert len(want) == count
    assert sorted(module.__all__) == sorted(want)
    assert not [name for name in want if not hasattr(module, name)]


def test_image_names_reach_the_top_level():
    for name in TI.__all__:
        assert name in torchmetrics_tpu_torch.__all__ and getattr(torchmetrics_tpu_torch, name) is getattr(TI, name)
    for name in TFI.__all__:
        assert name in TF_ALL.__all__ and getattr(TF_ALL, name) is getattr(TFI, name)
    # as in the JAX package, `functional.image` re-exports the PPL function of `image/`
    from torchmetrics_tpu_torch.image.perceptual_path_length import perceptual_path_length

    assert TFI.perceptual_path_length is perceptual_path_length


@pytest.mark.parametrize(
    ("relpath", "module", "count"),
    [("regression/__init__.py", TR, 19), ("functional/regression/__init__.py", TFR, 19),
     ("functional/pairwise/__init__.py", TFP, 5), ("retrieval/__init__.py", TRET, 12),
     ("functional/retrieval/__init__.py", TFRET, 10)],
)
def test_regression_pairwise_retrieval_all_equals_the_jax_package(relpath, module, count):
    want = _jax_all(relpath)
    assert len(want) == count
    assert sorted(module.__all__) == sorted(want)
    assert not [name for name in want if not hasattr(module, name)]


def test_regression_pairwise_retrieval_names_reach_the_top_level():
    for module in (TR, TRET):
        for name in module.__all__:
            assert name in torchmetrics_tpu_torch.__all__ and getattr(torchmetrics_tpu_torch, name) is getattr(module, name)
    for module in (TFR, TFP, TFRET):
        for name in module.__all__:
            assert name in TF_ALL.__all__ and getattr(TF_ALL, name) is getattr(module, name)


def test_utilities_all_equals_the_jax_package_but_the_compile_path():
    """``ring_push`` came with the compile path, ``sync_in_jit`` with ``_spmd``'s ``to_spmd``: the lists are equal."""
    want = _jax_all("utilities/__init__.py")
    assert len(want) == 26
    assert "ring_push" in TU.__all__ and "sync_in_jit" in TU.__all__
    assert sorted(TU.__all__) == sorted(want)
    assert not [name for name in TU.__all__ if not hasattr(TU, name)]


def _jax_top_level_strings(relpath):
    """The plain string entries of a JAX ``__all__`` that also splices other lists in with ``*``."""
    with open(os.path.join(ROOT, "torchmetrics_tpu", relpath)) as fh:
        tree = ast.parse(fh.read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(getattr(t, "id", None) == "__all__" for t in node.targets):
            return [el.value for el in node.value.elts if isinstance(el, ast.Constant)]
    raise AssertionError(f"no __all__ in {relpath}")


@pytest.mark.parametrize(("relpath", "module"), [("__init__.py", torchmetrics_tpu_torch), ("functional/__init__.py", TF_ALL)])
def test_submodule_names_the_port_has_are_listed(relpath, module):
    """Each submodule name of the JAX ``__all__`` that the port has is in the port's ``__all__``, as a module."""
    import types

    package = os.path.dirname(module.__file__)
    ported = [name for name in _jax_top_level_strings(relpath)
              if os.path.isdir(os.path.join(package, name)) or os.path.isfile(os.path.join(package, name + ".py"))]
    assert len(ported) == (14 if module is torchmetrics_tpu_torch else 12), ported
    for name in ported:
        assert name in module.__all__ and isinstance(getattr(module, name), types.ModuleType), name


def test_top_level_base_aggregator_and_version():
    from torchmetrics_tpu_torch.aggregation import BaseAggregator

    assert torchmetrics_tpu_torch.BaseAggregator is BaseAggregator and "BaseAggregator" in torchmetrics_tpu_torch.__all__
    with open(os.path.join(ROOT, "torchmetrics_tpu", "__about__.py")) as fh:
        jax_version = ast.literal_eval(next(line.split("=", 1)[1].strip() for line in fh if line.startswith("__version__")))
    assert "__version__" in torchmetrics_tpu_torch.__all__ and torchmetrics_tpu_torch.__version__ == jax_version


def test_new_classes_default_to_cuda():
    """Built without ``device=``, a metric keeps its states on ``cuda``: where there is no GPU it raises."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    for make in (lambda: TC.MulticlassJaccardIndex(num_classes=3), lambda: TC.Dice(),
                 lambda: TC.BinaryCalibrationError(), lambda: TC.MultilabelRankingLoss(num_labels=3),
                 lambda: TCL.AdjustedMutualInfoScore(), lambda: TCL.RandScore(), lambda: TCL.DunnIndex(),
                 lambda: TN.CramersV(num_classes=3), lambda: TN.TheilsU(), lambda: TN.FleissKappa()):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


@pytest.mark.parametrize(
    ("relpath", "module", "count"),
    [("clustering/__init__.py", TCL, 12), ("nominal/__init__.py", TN, 5), ("wrappers/__init__.py", TW, 9),
     ("functional/clustering/__init__.py", TFCL, 16), ("functional/nominal/__init__.py", TFN, 9)],
)
def test_clustering_nominal_wrappers_all_equals_the_jax_package(relpath, module, count):
    want = _jax_all(relpath)
    assert len(want) == count
    assert sorted(module.__all__) == sorted(want)
    assert not [name for name in want if not hasattr(module, name)]


def test_clustering_nominal_wrappers_names_reach_the_top_level():
    for module in (TCL, TN, TW):
        for name in module.__all__:
            assert name in torchmetrics_tpu_torch.__all__ and getattr(torchmetrics_tpu_torch, name) is getattr(module, name)
    for module in (TFCL, TFN):
        for name in module.__all__:
            assert name in TF_ALL.__all__ and getattr(TF_ALL, name) is getattr(module, name)


def _jax_names(relpath, seen=None):
    """Every name a JAX ``__all__`` lists, its ``*`` splices of other modules' ``__all__`` followed."""
    with open(os.path.join(ROOT, "torchmetrics_tpu", relpath)) as fh:
        tree = ast.parse(fh.read())
    spliced = {}
    for node in tree.body:
        if isinstance(node, ast.ImportFrom) and node.module and any(a.name == "__all__" for a in node.names):
            alias = next(a.asname for a in node.names if a.name == "__all__")
            spliced[alias] = node.module.replace("torchmetrics_tpu.", "").replace(".", "/")
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(getattr(t, "id", None) == "__all__" for t in node.targets):
            names = []
            for el in node.value.elts:
                if isinstance(el, ast.Constant):
                    names.append(el.value)
                else:  # *_x_all
                    sub = spliced[el.value.id]
                    path = sub + "/__init__.py" if os.path.isdir(os.path.join(ROOT, "torchmetrics_tpu", sub)) else sub + ".py"
                    names.extend(_jax_all(path))
            return names
    raise AssertionError(f"no __all__ in {relpath}")


@pytest.mark.parametrize(
    ("relpath", "module", "count", "ported"),
    [("__init__.py", torchmetrics_tpu_torch, 235, 233), ("functional/__init__.py", TF_ALL, 220, 220)],
)
def test_the_top_level_gap_is_only_what_is_not_ported_yet(relpath, module, count, ported):
    """The functional list is complete; the top level lacks only the AOT helpers (queue item 7)."""
    want = _jax_names(relpath)
    assert len(want) == count and len(module.__all__) == ported
    aot = {"get_aot_cache", "set_aot_cache"} if module is torchmetrics_tpu_torch else set()
    assert set(want) - set(module.__all__) == aot
    assert not set(module.__all__) - set(want)


@pytest.mark.parametrize(
    ("relpath", "module", "count"),
    [("audio/__init__.py", TA, 10), ("functional/audio/__init__.py", TFA, 11), ("multimodal/__init__.py", TM, 2),
     ("functional/multimodal/__init__.py", TFM, 2), ("functional/segmentation/__init__.py", TFS, 6)],
)
def test_audio_multimodal_segmentation_all_equals_the_jax_package(relpath, module, count):
    want = _jax_all(relpath)
    assert len(want) == count
    assert sorted(module.__all__) == sorted(want)
    assert not [name for name in want if not hasattr(module, name)]


def test_audio_multimodal_names_reach_the_top_level():
    for module in (TA, TM):
        for name in module.__all__:
            assert name in torchmetrics_tpu_torch.__all__ and getattr(torchmetrics_tpu_torch, name) is getattr(module, name)
    for module in (TFA, TFM):
        for name in module.__all__:
            assert name in TF_ALL.__all__ and getattr(TF_ALL, name) is getattr(module, name)
    # as in the JAX package, the segmentation utilities stay in their submodule
    assert not set(TFS.__all__) & set(TF_ALL.__all__) and TF_ALL.segmentation is TFS


def test_resilience_all_equals_the_jax_package():
    """``_resilience.__all__``: the JAX package's 22 names, each defined."""
    import torchmetrics_tpu_torch._resilience as TRES

    want = _jax_all("_resilience/__init__.py")
    assert len(want) == 22
    assert sorted(TRES.__all__) == sorted(want)
    assert not [name for name in want if not hasattr(TRES, name)]


@pytest.mark.parametrize(
    "family", ["quarantined_batches", "sync_attempts", "sync_retries", "degradations", "snapshot_writes", "snapshot_bytes"]
)
def test_resilience_families_are_declared_and_emitted(family):
    """The observability families the resilience layer emits are declared as the JAX package declares them,
    and some module of the port's runtime increments each."""
    import glob

    from torchmetrics_tpu_torch._observability.export import EXPORT_SCHEMA

    with open(os.path.join(ROOT, "torchmetrics_tpu", "_observability", "export.py")) as fh:
        tree = ast.parse(fh.read())
    jax_schema = next(
        ast.literal_eval(node.value) for node in tree.body
        if isinstance(node, ast.AnnAssign) and getattr(node.target, "id", None) == "EXPORT_SCHEMA"
    )
    assert EXPORT_SCHEMA[family] == {"kind": jax_schema[family]["kind"], "labels": tuple(jax_schema[family]["labels"])}
    sources = glob.glob(os.path.join(ROOT, "torchmetrics_tpu_torch", "**", "*.py"), recursive=True)
    emitters = [path for path in sources if f'"{family}' in open(path).read() and "_observability" not in path]
    assert emitters, family


@pytest.mark.parametrize(
    ("relpath", "count"),
    [("_streams/__init__.py", 8), ("_streams/adapters.py", 2), ("_streams/pool.py", 5), ("_streams/durability.py", 2),
     ("_streams/telemetry.py", 2)],
)
def test_streams_all_equals_the_jax_package(relpath, count):
    """``_streams``' names: the JAX package's 8, and each module's own (the adapters' two wrappers among them)."""
    import importlib

    module = importlib.import_module("torchmetrics_tpu_torch." + relpath[:-3].replace("/__init__", "").replace("/", "."))
    want = _jax_all(relpath)
    assert len(want) == count
    assert sorted(module.__all__) == sorted(want)
    assert not [name for name in want if not hasattr(module, name)]


@pytest.mark.parametrize(
    "family",
    ["pool_stream_updates", "pool_quarantined", "pool_violations", "pool_attach", "pool_detach", "pool_growths",
     "pool_computes", "pool_cost_device_seconds", "pool_cost_flops", "pool_cost_state_byte_updates"],
)
def test_stream_pool_families_are_declared_and_emitted(family):
    """The families a stream pool emits are declared as the JAX package declares them, and the pool increments each."""
    from torchmetrics_tpu_torch._observability.export import EXPORT_SCHEMA

    with open(os.path.join(ROOT, "torchmetrics_tpu", "_observability", "export.py")) as fh:
        tree = ast.parse(fh.read())
    jax_schema = next(
        ast.literal_eval(node.value) for node in tree.body
        if isinstance(node, ast.AnnAssign) and getattr(node.target, "id", None) == "EXPORT_SCHEMA"
    )
    assert EXPORT_SCHEMA[family] == {"kind": jax_schema[family]["kind"], "labels": tuple(jax_schema[family]["labels"])}
    with open(os.path.join(ROOT, "torchmetrics_tpu_torch", "_streams", "pool.py")) as fh:
        assert f'"{family}' in fh.read()
