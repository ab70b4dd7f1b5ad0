"""The port's mesh steps on CPU gloo groups: ``build_prefill_step``,
``build_decode_step`` and ``build_train_step`` over 1- and 2-rank
(``(1, 2)``) meshes against the port's one-device path, and that path
against the JAX reference (the 4-rank ``(2, 2)`` mesh:
``test_torch_mesh_steps_4.py``).

Five smoke architectures (qwen3, mamba2, grok-1's MoE, seamless's encoder
and cross-attention, hymba's attention beside SSD heads: the reference's
own small-mesh set) in f32, from the reference's ``init_params`` carried
across by ``interop.params_from_numpy``.  One spawn per world size runs
every check (``_torch_mesh_worker.py``) over a ``FileStore`` under the
test's temporary directory; rank 0 hands back what it measured.

Tolerances: one rank is bitwise the one-device path (the same local ops);
two ranks reorder f32 sums (a tensor-parallel contraction is a sum of
partial sums, then an all-reduce), so logits agree within 2e-5 of their
largest magnitude and losses within rtol 1e-5; greedy tokens are equal.
Parameters after two AdamW steps are held as ``chip_smoke.py`` holds the
CPU against the card: every element within 2 x lr x steps and at most a
thousandth of them beyond 0.01 lr.  AdamW divides each gradient by its own
running RMS, so an element whose gradient is near zero turns f32 rounding
into a visible part of its step.
The kernel route (the plain twins here) is held the same way on two ranks,
and its decode must take the split-KV partials route (the cache is sharded
on its rows) where one device takes the fused route.  The one-device path
is within 1e-4 of the reference's logits and rtol 1e-5 of its loss.  The
trained qwen3 parameters the 2-rank run saves restore onto one rank
bitwise.
"""

import dataclasses
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mesh_worker as W
from _torch_mesh_worker import check_kernel_route, check_serve, check_train, close
from repro.configs.archs import get_config as j_get_config
from repro.models.model import Model as JModel
from test_torch_threads import one_torch_thread  # noqa: F401

REF_LOGIT_TOL = 1e-4  # the one-device path against the reference
LOSS_RTOL = 1e-5


def _reference(arch):
    """-> (numpy params, serve batch, train batches, reference logits per
    step, reference loss of the first train step: its two microbatches'
    mean)."""
    j_cfg = dataclasses.replace(j_get_config(arch, smoke=True), dtype="float32",
                                attn_impl="dense")
    model = JModel(j_cfg)
    j_params, _ = model.init_params(jax.random.PRNGKey(0))
    serve, train = W.batches(j_cfg, seed=7)
    extra = {k: jnp.asarray(v) for k, v in serve.items() if k != "tokens"}
    logits, cache = model.prefill(
        j_params, {"tokens": jnp.asarray(serve["tokens"][:, :W.PROMPT]), **extra}, W.MAX_LEN)
    want = [np.asarray(logits)]
    for t in range(W.PROMPT, W.PROMPT + W.STEPS):
        logits, cache = model.decode_step(j_params, jnp.asarray(serve["tokens"][:, t:t + 1]),
                                          cache)
        want.append(np.asarray(logits))
    rows = W.TRAIN_BATCH // 2
    loss = np.mean([float(model.loss_fn(j_params, {k: jnp.asarray(v[i * rows:(i + 1) * rows])
                                                   for k, v in train[0].items()})[0])
                    for i in range(2)])
    return jax.device_get(j_params), serve, train, want, loss


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh")
    refs = {arch: _reference(arch) for arch in W.ARCHS}
    with open(d / "given.pkl", "wb") as f:
        pickle.dump({a: r[:3] for a, r in refs.items()}, f)
    out = {}
    for world, ckpt in ((2, "save"), (1, "restore")):
        path = d / f"out{world}.pkl"
        W.spawn(W.run, world, str(d / f"store{world}"), world, str(d / "given.pkl"), str(path),
                str(d / "ckpt"), ckpt, world == 2)
        with open(path, "rb") as f:
            out[world] = pickle.load(f)
    return refs, out


@pytest.mark.parametrize("world", [1, 2])
@pytest.mark.parametrize("arch", W.ARCHS)
def test_prefill_decode_steps_match_one_device(runs, world, arch):
    check_serve(runs[1][world], arch, world, world)


@pytest.mark.parametrize("arch", W.KERNEL_ARCHS)
def test_kernel_route_on_local_shards(runs, arch):
    check_kernel_route(runs[1][2], arch)


@pytest.mark.parametrize("world", [1, 2])
@pytest.mark.parametrize("arch", W.ARCHS)
def test_train_step_matches_one_device(runs, world, arch):
    check_train(runs[1][world], arch, world)


@pytest.mark.parametrize("arch", W.ARCHS)
def test_one_device_path_matches_reference(runs, arch):
    refs, out = runs
    _, _, _, want, want_loss = refs[arch]
    for i, (g, w) in enumerate(zip(out[1][(arch, "serve", "one")], want)):
        close(g, torch.from_numpy(np.array(w)), REF_LOGIT_TOL, f"{arch} vs reference, step {i}")
    np.testing.assert_allclose(out[1][(arch, "train", "one")][0][0], want_loss, rtol=LOSS_RTOL)


def test_checkpoint_from_two_ranks_restores_bitwise_on_one(runs):
    out = runs[1]
    saved = out[2][("qwen3-1.7b", "train", "mesh")][1]
    restored = out[1]["restored"]
    assert len(restored) == len(saved)
    assert all(torch.equal(a, b) for a, b in zip(restored, saved))
    assert any(pl.is_shard() for p in out[1]["restored_placements"] for pl in p)
