"""The port's checkpoint readers and writers against the JAX package's on the
CPU: the reference state-dict layout (``models/io_torch.py``) both ways, the
JAX package's ``.ckpt`` read without jax or optax, and reference ``.pt``
files in both directions, all bitwise. Narrow models (32/16/16 widths).
Every test runs in a fresh child process (``isolate``).
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

from test_torch_data import CAMS, _cfgs

pytestmark = pytest.mark.isolate

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the model variants the state-dict layout distinguishes
_VARIANTS = {
    "plain": {},
    "deep_rgb": {"MODEL.DEEP_RGB": True},
    "same_spacenet": {"MODEL.SAME_SPACENET": True},
    "view_pose": {"MODEL.USE_DEFORM_VIEW": True, "MODEL.POSE_REFINEMENT": True},
}


def _specs(**overrides):
    """(JAX spec, port spec) of the narrow model with ``overrides``."""
    from stnerf_tpu.models import LayeredSpec as JSpec
    from stnerf_tpu_torch.models import LayeredSpec

    jcfg, tcfg = _cfgs(("unused", "unused"), **overrides)
    return JSpec.from_cfg(jcfg, camera_num=CAMS), LayeredSpec.from_cfg(tcfg, camera_num=CAMS)


def _jax_params(jspec, seed=0):
    """A JAX parameter pytree with numpy leaves, every leaf distinct."""
    import jax

    from stnerf_tpu.models import init_layered_params

    params = jax.tree.map(np.asarray, init_layered_params(jax.random.PRNGKey(seed), jspec))
    rng = np.random.default_rng(seed)
    # fresh biases are zero and copies share values: make every leaf differ
    return jax.tree.map(lambda x: (x + rng.normal(size=x.shape)).astype(np.float32), params)


def _leaves(tree, prefix=""):
    """{path: leaf} of a nested dict/list tree."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_leaves(v, f"{prefix}/{k}"))
    return out


def _assert_trees_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert sorted(la) == sorted(lb)
    for k in la:
        x, y = np.asarray(la[k]), np.asarray(lb[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)


def _model(tspec, tree):
    import torch

    from stnerf_tpu_torch.models import LayeredModel, load_jax_params

    return load_jax_params(LayeredModel(tspec, torch.Generator().manual_seed(1),
                                        device="cpu"), tree)


def test_state_dict_layout_matches_jax():
    """``state_dict_from_params`` and ``params_from_state_dict`` give the JAX
    functions' results bitwise, both ways, for every model variant; a
    ``LayeredModel`` carries the tree through unchanged."""
    from stnerf_tpu.models import io_torch as jio
    from stnerf_tpu_torch.models import export_jax_params, io_torch

    for name, overrides in _VARIANTS.items():
        jspec, tspec = _specs(**overrides)
        params = _jax_params(jspec)
        sd = io_torch.state_dict_from_params(params, tspec)
        jsd = jio.state_dict_from_params(params, jspec)
        assert list(sd) == list(jsd), name
        _assert_trees_equal(sd, jsd)
        back = io_torch.params_from_state_dict(sd, tspec)
        _assert_trees_equal(back, jio.params_from_state_dict(jsd, jspec))
        _assert_trees_equal(back, params)
        _assert_trees_equal(export_jax_params(_model(tspec, back)), params)
    assert any(k.startswith("cam_pose.") for k in sd)
    assert any(k.startswith("view_deform_net.") for k in sd)


def _save_jax_ckpt(tmp_path, jcfg, params, **kw):
    from stnerf_tpu.engine.checkpoint import save_checkpoint
    from stnerf_tpu.engine.solver import make_frozen_mask, make_optimizer

    # Adam under a frozen-group mask: ScaleByAdamState, MaskedState, ...
    tx = make_optimizer(jcfg, make_frozen_mask(params, ["bkgd_coarse"]))
    return save_checkpoint(str(tmp_path), params, tx.init(params), **kw)


def test_jax_ckpt_loads_without_jax(tmp_path):
    """A ``.ckpt`` the JAX package writes (with a real optimizer state)
    loads into the port bitwise, and in a process that has neither jax nor
    optax; other globals and ml_dtypes leaves are refused."""
    import ml_dtypes

    from stnerf_tpu_torch.engine import load_jax_checkpoint, load_params_any
    from stnerf_tpu_torch.models import LayeredModel, export_jax_params

    jcfg, _ = _cfgs(("unused", "unused"))
    jspec, tspec = _specs()
    params = _jax_params(jspec)
    path = _save_jax_ckpt(tmp_path, jcfg, params, epoch=3, step=7)
    assert os.path.basename(path) == "layered_rfnr_checkpoint_3_7.ckpt"
    blob = load_jax_checkpoint(path)
    assert (blob["epoch"], blob["step"]) == (3, 7)
    _assert_trees_equal(blob["params"], params)
    model = load_params_any(path, LayeredModel(tspec, device="cpu"))
    _assert_trees_equal(export_jax_params(model), params)

    code = ("import sys; from stnerf_tpu_torch.engine.checkpoint import "
            "load_jax_checkpoint; b = load_jax_checkpoint(sys.argv[1]); "
            "assert 'jax' not in sys.modules, 'jax loaded'; "
            "assert 'optax' not in sys.modules, 'optax loaded'; "
            "print(b['epoch'], sorted(b['params']))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    r = subprocess.run([sys.executable, "-c", code, path], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    assert r.stdout.split()[0] == "3"

    import collections

    bad = tmp_path / "layered_rfnr_checkpoint_9.ckpt"
    bad.write_bytes(pickle.dumps({"params": collections.OrderedDict()}, protocol=4))
    with pytest.raises(pickle.UnpicklingError, match="refusing to unpickle collections"):
        load_jax_checkpoint(str(bad))
    bad.write_bytes(pickle.dumps({"params": {"w": np.ones(2, ml_dtypes.bfloat16)}},
                                 protocol=4))
    with pytest.raises(pickle.UnpicklingError, match="ml_dtypes dtype bfloat16"):
        load_jax_checkpoint(str(bad))


def test_reference_pt_both_directions(tmp_path):
    """A ``.pt`` the JAX package exports loads into the port bitwise; the
    port's export loads back into the JAX package bitwise; the port's own
    format goes through the same dispatcher; a ``.pt`` holding more than
    weights is refused."""
    import argparse

    import torch

    from stnerf_tpu.engine.checkpoint import export_reference_checkpoint as jexport
    from stnerf_tpu.models.io_torch import load_reference_checkpoint as jload
    from stnerf_tpu_torch.engine import (export_reference_checkpoint, load_params_any,
                                         save_checkpoint)
    from stnerf_tpu_torch.models import LayeredModel, export_jax_params

    jspec, tspec = _specs(**_VARIANTS["view_pose"])
    params = _jax_params(jspec)
    ref = jexport(str(tmp_path / "layered_rfnr_checkpoint_2.pt"), params, jspec)
    model = load_params_any(ref, LayeredModel(tspec, device="cpu"))
    _assert_trees_equal(export_jax_params(model), params)

    out = export_reference_checkpoint(str(tmp_path / "layered_rfnr_checkpoint_5.pt"), model)
    _assert_trees_equal(jload(out, jspec), params)
    sd = torch.load(out, weights_only=True)["model"]
    assert all(v.dtype == torch.float32 and v.device.type == "cpu" for v in sd.values())

    own = save_checkpoint(str(tmp_path / "own"), model, epoch=4)
    again = load_params_any(own, LayeredModel(tspec, device="cpu"))
    _assert_trees_equal(export_jax_params(again), params)

    torch.save({"model": sd, "args": argparse.Namespace(x=1)},
               str(tmp_path / "layered_rfnr_checkpoint_6.pt"))
    with pytest.raises(pickle.UnpicklingError, match="argparse"):
        load_params_any(str(tmp_path / "layered_rfnr_checkpoint_6.pt"),
                        LayeredModel(tspec, device="cpu"))
    with pytest.raises(ValueError, match="not a checkpoint name"):
        load_params_any(str(tmp_path / "weights.pt"), model)
