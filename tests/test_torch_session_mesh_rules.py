"""The session mesh's placement against the reference: the port's
``state.object_spec`` rule and the DTensor placements of
``shard_over_objects`` / ``shard_session_state`` leaf by leaf against the
``PartitionSpec`` the reference's ``shard_over_objects`` /
``shard_session_state`` give on a 4-device JAX host mesh (a subprocess
with ``--xla_force_host_platform_device_count=4``: device placement only).

The rule is held on mesh stand-ins (no process group) for meshes of 1, 2
and 4 devices on the "data" axis, a ("data", "model") mesh and a ("pod",
"data", "model") one, over leaves that divide, that do not, that are
shorter than the axis, scalars, and ``object_axis=1`` stacks; the
placements on real ("data", "model") gloo meshes of 4 ranks — 1, 2 and 4
on the object axis — in one spawn.
"""

import json
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import pytest

import _torch_session_mesh_worker as W
from repro_torch.core.state import object_spec
from test_torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
SHAPES = [(64, 4, 4), (6, 3), (), (3,), (4,), (2, 128), (2, 130), (8, 2), (1, 64)]
MESHES = {  # name -> axis names and sizes
    "data1": {"data": 1}, "data2": {"data": 2}, "data4": {"data": 4},
    "data2_model2": {"data": 2, "model": 2}, "data1_model4": {"data": 1, "model": 4},
    "pod2_data2": {"pod": 2, "data": 2, "model": 1},
}


def _reference_specs() -> dict:
    """{(mesh, shape, object_axis): spec as a tuple} from the reference,
    and its ``shard_session_state`` layout of a session state."""
    code = textwrap.dedent("""
        import os, json
        os.environ["XLA_FLAGS"] = os.environ.get("XLA_FLAGS", "") + \\
            " --xla_force_host_platform_device_count=4"
        import jax, jax.numpy as jnp, numpy as np
        from jax.sharding import Mesh
        from repro.core import state as state_lib
        from repro.core.durability import shard_session_state

        assert jax.device_count() == 4
        meshes = json.loads(os.environ["MESHES"])
        shapes = [tuple(s) for s in json.loads(os.environ["SHAPES"])]

        def entry(e):
            return list(e) if isinstance(e, tuple) else e

        out = {}
        for name, axes in meshes.items():
            n = int(np.prod(list(axes.values())))
            mesh = Mesh(np.array(jax.devices()[:n]).reshape(tuple(axes.values())),
                        tuple(axes))
            for shape in shapes:
                for axis in (0, 1):
                    x = state_lib.shard_over_objects(jnp.zeros(shape), mesh, object_axis=axis)
                    out[json.dumps([name, list(shape), axis])] = [
                        entry(e) for e in x.sharding.spec]
        from repro.core import EngineSession, MultiQueryConfig, Predicate
        from repro.core import fallback_decision_table
        from repro.core.combine import default_combine_params
        P, F = 4, 4
        aucs = jnp.full((P, F), 0.8)
        sess = EngineSession([Predicate(i, 1) for i in range(P)],
                             fallback_decision_table(P, F, aucs), default_combine_params(aucs),
                             jnp.full((P, F), 0.1), capacity=128, max_tenants=2,
                             config=MultiQueryConfig(plan_size=32))
        st = sess.init_state(jnp.full((120, P, F), 0.5))
        mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
        placed = shard_session_state(st, mesh)
        flat, _ = jax.tree_util.tree_flatten_with_path(placed)
        out["session"] = {jax.tree_util.keystr(k): [entry(e) for e in v.sharding.spec]
                          for k, v in flat}
        print("SPECS" + json.dumps(out))
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu",
               MESHES=json.dumps(MESHES), SHAPES=json.dumps([list(s) for s in SHAPES]))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, timeout=600)
    line = [x for x in proc.stdout.splitlines() if x.startswith("SPECS")]
    assert line, proc.stderr[-4000:]
    return json.loads(line[0][5:])


@pytest.fixture(scope="module")
def reference():
    return _reference_specs()


def _as_json(spec) -> list:
    return [list(e) if isinstance(e, tuple) else e for e in spec]


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_object_spec_is_the_references_rule(reference, mesh):
    stand_in = SimpleNamespace(axis_names=tuple(MESHES[mesh]), shape=MESHES[mesh])
    for shape in SHAPES:
        for axis in (0, 1):
            want = reference[json.dumps([mesh, list(shape), axis])]
            got = _as_json(object_spec(stand_in, shape, object_axis=axis))
            # the reference spells trailing unsharded dims out; a spec's
            # missing entries are None
            assert got + [None] * (len(want) - len(got)) == want, (mesh, shape, axis)


REAL = {(1, 4): "data1_model4", (2, 2): "data2_model2", (4, 1): "data4"}


@pytest.fixture(scope="module")
def placed(tmp_path_factory):
    d = tmp_path_factory.mktemp("session_mesh_rules")
    W.spawn(W.placements_only, 4, str(d / "store"), str(d / "out.pkl"), SHAPES)
    with open(d / "out.pkl", "rb") as f:
        return pickle.load(f)


@pytest.mark.parametrize("shape", sorted(REAL))
def test_shard_over_objects_places_leaves_as_the_reference(reference, placed, shape):
    leaves, _ = placed[shape]
    for (leaf, axis), spec in leaves.items():
        want = reference[json.dumps([REAL[shape], list(leaf), axis])]
        while want and want[-1] is None:
            want = want[:-1]
        assert spec == want, (shape, leaf, axis, spec, want)


@pytest.mark.parametrize("shape", sorted(REAL))
def test_session_state_layout_is_the_references(reference, placed, shape):
    """``shard_session_state`` on each real mesh places every leaf as the
    reference's does on a 2-device mesh (128 rows divide over all of them):
    row leaves on their row axis, the rest replicated."""
    _, placements = placed[shape]
    want = {path: next((i for i, e in enumerate(spec) if e is not None), None)
            for path, spec in reference["session"].items()}
    assert placements.keys() == want.keys()
    for path, dims in placements.items():
        shard = next((d for d in dims if d is not None), None)
        assert shard == want[path], (shape, path, dims, want[path])
