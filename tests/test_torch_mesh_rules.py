"""The port's sharding rules and logical axes against the JAX reference.

``rules_for_cell`` (every divisibility fallback) and ``ShardingRules.spec``
/ ``filter_for_mesh`` for all ten architectures x the four shapes x the
single- and multi-pod production meshes (stand-in mesh objects, as the
reference's own rule tests use), the parameter axes of ``Model.param_axes``
against the reference's ``init_params(key)[1]`` (traced under
``eval_shape`` at full width: nothing allocated) and
``transformer.model_cache_axes`` against the reference's; the spec never
maps two tensor dims to one mesh axis, and ``placements`` turns a spec into
one DTensor placement per mesh dim.  The mesh modules (and the CPU gloo
worker and ``chip_smoke.py``) import neither JAX nor the reference.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest
from torch.distributed.tensor import Replicate, Shard

from repro.configs.archs import ARCHS
from repro.configs.archs import get_config as j_get_config
from repro.launch.rules import rules_for_cell as j_rules_for_cell
from repro.models.model import Model as JModel
from repro.models.sharding import ShardingRules as JRules
from repro.models.sharding import default_rules as j_default_rules
from repro.models.transformer import model_cache_axes as j_model_cache_axes
from repro_torch.configs.archs import get_config
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch.rules import rules_for_cell
from repro_torch.launch.steps import input_axes
from repro_torch.models import transformer as tf
from repro_torch.models.model import Model
from repro_torch.models.sharding import ShardingRules, default_rules, is_axes_leaf, map_axes


class SinglePod:
    axis_names = ("data", "model")
    shape = {"data": 16, "model": 16}


class MultiPod:
    axis_names = ("pod", "data", "model")
    shape = {"pod": 2, "data": 16, "model": 16}


MESHES = {"pod16x16": SinglePod(), "pod2x16x16": MultiPod()}
CACHE_FIELDS = ("kv_k", "kv_v", "ssm_conv", "ssm_h", "length", "enc_out")


def _reference_axes(arch):
    captured = {}

    def init(key):
        params, axes = JModel(j_get_config(arch)).init_params(key)
        captured["axes"] = axes
        return params

    jax.eval_shape(init, jax.random.PRNGKey(0))
    return captured["axes"]


def _axes_leaves(tree) -> list:
    out = []
    map_axes(out.append, tree)
    return out


def _all_axes(arch) -> set:
    """Every logical-axes tuple the cell builders place: parameters, cache,
    inputs."""
    cfg = get_config(arch)
    leaves = _axes_leaves(Model(cfg).param_axes())
    cache = tf.model_cache_axes(cfg, shard_kv_seq=True)
    leaves += _axes_leaves(cache)
    for spec in SHAPES.values():
        leaves += list(input_axes(cfg, spec).values())
    return {tuple(a) for a in leaves}


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_rules_and_specs_match_reference(arch, mesh_name):
    mesh = MESHES[mesh_name]
    cfg, j_cfg = get_config(arch), j_get_config(arch)
    axes = _all_axes(arch)
    for shape in SHAPES.values():
        mine = rules_for_cell(cfg, mesh, shape.kind, shape.global_batch)
        ref = j_rules_for_cell(j_cfg, mesh, shape.kind, shape.global_batch)
        assert mine.rules == ref.rules, (arch, shape.name)
        for ax in axes:
            spec = mine.spec(ax)
            assert tuple(spec) == tuple(ref.spec(ax)), (arch, shape.name, ax)
            assert tuple(ShardingRules.filter_for_mesh(mesh, spec)) == tuple(
                JRules.filter_for_mesh(mesh, ref.spec(ax))), (arch, shape.name, ax)
            used = [a for e in spec if e is not None for a in (e if isinstance(e, tuple) else (e,))]
            assert len(used) == len(set(used)), (arch, shape.name, ax, spec)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_axes_match_reference(arch):
    assert Model(get_config(arch)).param_axes() == _reference_axes(arch)


@pytest.mark.parametrize("shard_kv_seq", [False, True])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cache_axes_match_reference(arch, shard_kv_seq):
    mine = tf.model_cache_axes(get_config(arch), shard_kv_seq=shard_kv_seq)
    ref = j_model_cache_axes(j_get_config(arch), shard_kv_seq=shard_kv_seq)
    for f in CACHE_FIELDS:
        assert getattr(mine, f) == getattr(ref, f), (arch, f)


def test_divisibility_fallbacks():
    mesh = SinglePod()
    r = rules_for_cell(get_config("arctic-480b"), mesh, "train", 256)  # 56 heads
    assert r.rules["heads"] is None and r.rules["head_dim"] == "model"
    assert r.rules["experts"] == "data" and r.rules["expert_embed"] == ()
    assert rules_for_cell(get_config("seamless-m4t-large-v2"), mesh, "train", 256).rules[
        "vocab"] is None  # 256,206 tokens
    assert rules_for_cell(get_config("grok-1-314b"), mesh, "train", 256).rules["experts"] is None
    r = rules_for_cell(get_config("gemma2-9b"), mesh, "decode", 1)
    assert r.rules["batch"] is None and r.rules["kv_seq"] == ("data", "model")
    assert rules_for_cell(get_config("qwen3-1.7b"), mesh, "train", 256).rules["seq"] == "model"


@pytest.mark.parametrize("experts", [None, 8, 128])
def test_default_rules_match_reference(experts):
    for mesh in MESHES.values():
        assert default_rules(mesh, experts).rules == j_default_rules(mesh, experts).rules


def test_placements_one_per_mesh_dim():
    r = rules_for_cell(get_config("gemma2-9b"), MultiPod(), "decode", 1)
    mesh = MultiPod()
    # kv_seq over (pod, data, model), major first: Shard(2) on every mesh dim
    assert r.placements(mesh, ("layers", "batch", "kv_seq", "kv_heads", "head_dim")) == (
        Shard(2), Shard(2), Shard(2))
    r = rules_for_cell(get_config("qwen3-1.7b"), mesh, "train", 256)
    assert r.placements(mesh, ("embed", "heads", "head_dim")) == (Shard(0), Shard(0), Shard(1))
    assert r.placements(mesh, ("embed_unsharded",)) == (Replicate(),) * 3
    r = rules_for_cell(get_config("qwen3-1.7b"), SinglePod(), "train", 256)
    assert r.placements(SinglePod(), ("batch", "seq")) == (Shard(0), Shard(1))


def test_axes_leaf_rule():
    assert is_axes_leaf(("layers", None)) and is_axes_leaf(())
    assert not is_axes_leaf((None,)) and not is_axes_leaf((None, None))


def test_mesh_modules_import_neither_jax_nor_the_reference():
    repo = Path(__file__).resolve().parents[1]
    code = ("import sys\n"
            "import repro_torch.launch.mesh, repro_torch.launch.rules, repro_torch.launch.dryrun\n"
            "import repro_torch.launch.steps, repro_torch.launch.train, repro_torch.interop\n"
            "import repro_torch.models.sharding, repro_torch.models.activation_sharding\n"
            "import _torch_mesh_worker, chip_smoke\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
            "       or m == 'repro' or m.startswith('repro.')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(repo / "src"), str(repo), str(repo / "tests")]))
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
