"""The port's dry run (``repro_torch.launch.dryrun``) against the
reference's sharding arithmetic.

In a subprocess (the fake 256-rank process group must not stay in the test
worker) it dry-runs ``qwen3-1.7b x decode_32k`` and ``grok-1-314b x
train_4k`` at smoke width on the (16, 16) mesh.  Each cell's per-device
argument bytes must equal what the reference's specs give by arithmetic
over its ``eval_shape`` shapes: every leaf's dims divided (rounded up) by
the mesh axes its ``ShardingRules.spec`` names, in the dtype the
reference's step gives it (bf16 serving parameters; f32 parameters, AdamW
moments sharded like the parameter of the same shape and dtype, an int32
step, for training).  The collectives must be where the rules put them:
FSDP all-gathers of the parameters, and the tensor-parallel sums as
all-reduces or reduce-scatters.
"""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp

from repro.configs.archs import get_config as j_get_config
from repro.configs.shapes import SHAPES
from repro.launch.rules import rules_for_cell
from repro.models.model import Model as JModel
from repro.models.transformer import init_model_cache, model_cache_axes
from repro.optim.adamw import AdamW

CELLS = (("qwen3-1.7b", "decode_32k"), ("grok-1-314b", "train_4k"))
SIZES = {"data": 16, "model": 16}


class Mesh16:
    axis_names = ("data", "model")
    shape = SIZES


def _is_axes(x):
    return isinstance(x, tuple) and all(e is None or isinstance(e, str) for e in x) and (
        len(x) == 0 or any(isinstance(e, str) for e in x))


def _local_bytes(shape, dtype, spec) -> int:
    n = 1
    for dim, entry in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        names = () if entry is None else entry if isinstance(entry, tuple) else (entry,)
        n *= -(-dim // math.prod(SIZES[a] for a in names))
    return n * jnp.dtype(dtype).itemsize


def _tree_bytes(shapes, axes, rules, dtype=None) -> int:
    shapes_l = jax.tree.leaves(shapes)
    axes_l = jax.tree.leaves(axes, is_leaf=_is_axes)
    assert len(shapes_l) == len(axes_l)
    return sum(_local_bytes(s.shape, dtype or s.dtype, rules.spec(a))
               for s, a in zip(shapes_l, axes_l))


def reference_argument_bytes(arch, shape_name) -> int:
    cfg = j_get_config(arch, smoke=True)
    spec = SHAPES[shape_name]
    rules = rules_for_cell(cfg, Mesh16(), spec.kind, spec.global_batch)
    captured = {}

    def init(key):
        p, a = JModel(cfg).init_params(key)
        captured["axes"] = a
        return p

    params = jax.eval_shape(init, jax.random.PRNGKey(0))
    axes = captured["axes"]
    b = spec.global_batch
    if spec.kind == "decode":
        total = _tree_bytes(params, axes, rules, jnp.bfloat16)  # all floating leaves
        total += _local_bytes((b, 1), jnp.int32, rules.spec(("batch", "seq")))
        cache = jax.eval_shape(lambda: init_model_cache(cfg, b, spec.seq_len,
                                                        cfg.activation_dtype))
        c_axes = model_cache_axes(cfg, shard_kv_seq=True)
        for f in ("kv_k", "kv_v", "ssm_conv", "ssm_h"):
            for s, a in zip(getattr(cache, f), getattr(c_axes, f)):
                if s is not None:
                    total += _local_bytes(s.shape, s.dtype, rules.spec(a))
        return total + 4  # the int32 length
    assert spec.kind == "train" and cfg.param_counts()["total"] < 2e11  # f32 + AdamW
    total = _tree_bytes(params, axes, rules)
    by_shape = {}
    for s, a in zip(jax.tree.leaves(params), jax.tree.leaves(axes, is_leaf=_is_axes)):
        by_shape.setdefault((s.shape, str(s.dtype)), rules.spec(a))
    opt = jax.eval_shape(AdamW().init, params)
    for leaf in jax.tree.leaves(opt):
        spec_of = by_shape.get((leaf.shape, str(leaf.dtype)), ())  # else replicated
        total += _local_bytes(leaf.shape, leaf.dtype, spec_of)
    tok = _local_bytes((b, spec.seq_len), jnp.int32, rules.spec(("batch", "seq")))
    return total + 2 * tok


def test_dry_run_bytes_and_collectives(tmp_path):
    code = ("from repro_torch.launch.dryrun import run_cell\n"
            f"for arch, shape in {CELLS!r}:\n"
            f"    run_cell(arch, shape, False, {str(tmp_path)!r}, smoke=True)\n")
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, PYTHONPATH=src + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    for arch, shape in CELLS:
        cell = json.loads((tmp_path / f"{arch}__{shape}__pod16x16.json").read_text())
        assert cell["status"] == "ok" and cell["device_count"] == 256
        mem = cell["memory"]
        assert mem["argument_bytes"] == reference_argument_bytes(arch, shape), (arch, mem)
        assert mem["temp_bytes"] is None and mem["output_bytes"] > 0
        counts = cell["collectives"]["count_by_kind"]
        assert counts["all-gather"] > 0, (arch, counts)  # FSDP: parameters gathered
        assert counts["all-reduce"] + counts["reduce-scatter"] > 0, (arch, counts)  # TP sums
        assert cell["collectives"]["bytes_by_kind"]["all-gather"] > 0
        assert cell["flops"]["total"] > 0
        assert cell["params_total"] == j_get_config(arch, smoke=True).param_counts()["total"]
