"""The port's mesh steps on a 4-rank ``(2, 2)`` CPU gloo mesh (the
data and the model axis both split): ``build_prefill_step``,
``build_decode_step`` and ``build_train_step`` against the one-device path
for the five smoke architectures of ``test_torch_mesh_steps.py``, with the
same tolerances; the kernel route's split-KV partials decode against the
fused route; and the qwen3 parameters a 2-rank run places and saves,
restored onto the four ranks bitwise.  The parameters are the port's own
``init_params`` (the one-device path is held to the reference in
``test_torch_mesh_steps.py``), so this file imports no JAX."""

import pickle

import pytest
import torch

import _torch_mesh_worker as W
from repro_torch import interop
from repro_torch.models.model import Model
from _torch_mesh_worker import check_kernel_route, check_serve, check_train
from test_torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def run4(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh4")
    given = {}
    for arch in W.ARCHS:
        cfg = W.config(arch)
        params = interop.tree_to_numpy(Model(cfg).init_params(torch.Generator().manual_seed(0)))
        given[arch] = (params, *W.batches(cfg, seed=11))
    with open(d / "given.pkl", "wb") as f:
        pickle.dump(given, f)
    W.spawn(W.save_only, 2, str(d / "store2"), str(d / "given.pkl"), str(d / "ckpt"))
    W.spawn(W.run, 4, str(d / "store4"), 2, str(d / "given.pkl"), str(d / "out.pkl"),
            str(d / "ckpt"), "restore", True)
    with open(d / "out.pkl", "rb") as f:
        return given, pickle.load(f)


@pytest.mark.parametrize("arch", W.ARCHS)
def test_prefill_decode_steps_on_four_ranks(run4, arch):
    check_serve(run4[1], arch, 4, 2)


@pytest.mark.parametrize("arch", W.KERNEL_ARCHS)
def test_kernel_route_on_four_ranks(run4, arch):
    check_kernel_route(run4[1], arch)


@pytest.mark.parametrize("arch", W.ARCHS)
def test_train_step_on_four_ranks(run4, arch):
    check_train(run4[1], arch, 4)


def test_checkpoint_from_two_ranks_restores_bitwise_on_four(run4):
    given, out = run4
    saved = W.leaves(interop.params_from_numpy(given["qwen3-1.7b"][0]))
    assert all(torch.equal(a, b) for a, b in zip(out["restored"], saved))
    assert len(out["restored"]) == len(saved)
    assert any(pl.is_shard() for p in out["restored_placements"] for pl in p)
