"""The session mesh on a 4-rank CPU gloo group: the placed session's
``TRACE`` at ``num_shards`` 4 and 8, both modes, bitwise the one-device
program (history, plans, every final leaf, digests); the replicated leaves
equal on every rank after every chunk; and a state placed on a (2, 2)
mesh (the object axis over 2 ranks, each shard held twice), run and saved
there, restored onto the (4, 1) mesh and run to the end, bitwise the
one-device run; and the same trace on a (2, 2, 1) ("pod", "data",
"model") mesh, whose object axis spans two mesh dims.  The world is the port's own draw
(``_torch_session_mesh_worker.port_world``: the reference's world is held
on 1 and 2 ranks in ``test_torch_session_mesh.py``), so this file imports
no JAX."""

import pickle

import pytest

import _torch_session_mesh_worker as W
from test_torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def run4(tmp_path_factory):
    d = tmp_path_factory.mktemp("session_mesh4")
    with open(d / "given.pkl", "wb") as f:
        pickle.dump(W.port_world(), f)
    W.spawn(W.run, 4, str(d / "store4"), str(d / "given.pkl"), str(d / "out.pkl"),
            str(d / "root4"), "")
    with open(d / "out.pkl", "rb") as f:
        return pickle.load(f)


@pytest.mark.parametrize("shards", [4, 8])
@pytest.mark.parametrize("mode", W.MODES)
def test_placed_trace_on_four_ranks_is_bitwise_the_one_device_run(run4, mode, shards):
    assert run4["mesh"] == (4, 1)
    W.check_mesh_vs_one(run4, mode, shards)


@pytest.mark.parametrize("mode", W.MODES)
def test_object_axis_over_pod_and_data_is_bitwise_the_one_device_run(run4, mode):
    W.check_pod_and_data(run4, mode)


def test_replicated_leaves_are_equal_on_four_ranks_after_every_chunk(run4):
    W.check_replicated(run4)


def test_state_saved_from_a_two_by_two_mesh_resumes_on_four_ranks_bitwise(run4):
    W.check_two_to_four(run4)
