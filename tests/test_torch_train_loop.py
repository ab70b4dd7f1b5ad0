"""The training loop side against the JAX package: the synthetic token
stream, the one-device train step, the >= 300B recipe, ``train_loop``'s
checkpoint / resume and preemption, train checkpoints across packages, and
the kernels' refusal to join a backward pass.

The train step's oracle is composed here from the reference's own pieces —
``Model.loss_fn`` under ``jax.value_and_grad``, a ``lax.scan`` over
microbatches summing f32 gradients, ``clip_by_global_norm`` and
``AdamW.update``, as ``repro/launch/steps.py:241-258`` does — because the
reference's ``build_train_step`` needs a mesh.  Tolerances: the loss,
``ce`` and ``grad_norm`` of each step within rtol 1e-5 (f32 sums in another
order); the parameters after 3 steps within ``2 * lr * steps`` everywhere
and within ``0.01 * lr`` for all but 0.1% of entries.  The loose bound is
for a gradient near 0 that rounds to opposite signs in XLA and in
PyTorch: AdamW's early updates are about ``lr * sign(g)``, so one such entry
moves by up to ``2 * lr`` a step (measured: every entry within 0.004 lr).
Within the port, resuming from a checkpoint is bitwise the uninterrupted
run.
"""

import dataclasses
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_train_parity import keyed
from repro.checkpoint import store as j_store
from repro.configs import shapes as j_shapes
from repro.configs.archs import get_config as j_get_config
from repro.data import pipeline as j_pipeline
from repro.models.model import Model as JModel
from repro.optim.adamw import AdamW as JAdamW
from repro.optim.adamw import clip_by_global_norm as j_clip
from repro_torch import interop
from repro_torch.checkpoint import store
from repro_torch.configs import shapes
from repro_torch.configs.archs import get_config
from repro_torch.data import pipeline
from repro_torch.kernels.autograd import NoBackwardError
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.enrich_score import ops as es_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.launch import steps, train
from repro_torch.models.model import Model
from repro_torch.optim.adafactor import Adafactor, AdafactorState
from repro_torch.optim.adamw import AdamW, AdamWState
from repro_torch.optim.tree import leaves
from repro_torch.runtime.fault_tolerance import PreemptionHandler
from test_torch_threads import one_torch_thread  # noqa: F401

B, S = 4, 32
LR = AdamW().lr


def _f32_smoke(arch="qwen3-1.7b"):
    return dataclasses.replace(j_get_config(arch, smoke=True), dtype="float32")


# ------------------------------------------------------------------ data ---

def test_token_stream_batches_are_the_references_bitwise():
    cfg = pipeline.TokenStreamConfig(vocab_size=97, seq_len=32, global_batch=4, seed=3)
    j_cfg = j_pipeline.TokenStreamConfig(vocab_size=97, seq_len=32, global_batch=4, seed=3)

    def extra(rng, b):
        return {"frames": rng.normal(size=(b, 5, 8)).astype(np.float32)}

    for step in (0, 5, 17):
        got = pipeline.SyntheticTokenStream(cfg, extra).batch(step)
        want = j_pipeline.SyntheticTokenStream(j_cfg, extra).batch(step)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(got["targets"][:, :-1], got["tokens"][:, 1:])


def test_prefetch_iterator_places_every_batch_and_raises_the_workers_error():
    stream = pipeline.SyntheticTokenStream(pipeline.TokenStreamConfig(17, 8, 2))
    it = pipeline.PrefetchIterator((stream.batch(i) for i in range(5)), device="cpu")
    got = list(it)
    it.thread.join(timeout=10)
    assert len(got) == 5 and not it.thread.is_alive()
    for i, b in enumerate(got):
        assert isinstance(b["tokens"], torch.Tensor)
        np.testing.assert_array_equal(b["tokens"].numpy(), stream.batch(i)["tokens"])

    def broken():
        yield stream.batch(0)
        raise OSError("shard unreadable")

    it = pipeline.PrefetchIterator(broken(), device="cpu")
    next(it)
    with pytest.raises(OSError, match="unreadable"):
        next(it)
    it = pipeline.PrefetchIterator(iter(stream), device="cpu", depth=1)  # endless
    next(it)
    it.close()
    assert not it.thread.is_alive()


def test_shapes_and_object_ranges_match_the_reference():
    assert {k: dataclasses.astuple(v) for k, v in shapes.SHAPES.items()} == {
        k: dataclasses.astuple(v) for k, v in j_shapes.SHAPES.items()}
    assert shapes.all_cells() == j_shapes.all_cells()
    spec = shapes.smoke_shape(shapes.SHAPES["train_4k"])
    assert dataclasses.astuple(spec) == dataclasses.astuple(
        j_shapes.smoke_shape(j_shapes.SHAPES["train_4k"]))
    for n, k in ((10, 3), (4, 4), (1000, 7)):
        assert pipeline.shard_object_ranges(n, k) == j_pipeline.shard_object_ranges(n, k)
    from repro_torch.configs import arctic_480b, qwen3_1_7b

    assert qwen3_1_7b.full() == get_config("qwen3-1.7b") and arctic_480b.smoke() == get_config(
        "arctic-480b", smoke=True)


# ------------------------------------------------------------ train step ---

def _oracle_step(j_model, mb):
    """The reference's step composed without a mesh (``steps.py:241-258``)."""
    opt = JAdamW()

    def step(params, opt_state, batch):
        br = jax.tree.map(lambda x: x.reshape((mb, x.shape[0] // mb) + x.shape[1:]), batch)

        def micro(gsum, mbatch):
            (_, metrics), grads = jax.value_and_grad(
                lambda p: j_model.loss_fn(p, mbatch), has_aux=True)(params)
            return jax.tree.map(lambda a, g: a + g.astype(jnp.float32), gsum, grads), metrics

        zeros = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), params)
        gsum, metrics_all = jax.lax.scan(micro, zeros, br)
        grads = jax.tree.map(lambda g: g / mb, gsum)
        grads, gnorm = j_clip(grads, 1.0)
        params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, dict(jax.tree.map(jnp.mean, metrics_all), grad_norm=gnorm)

    return jax.jit(step), opt


def _assert_params_close(got, want, steps_taken):
    got, want = keyed(interop.tree_to_numpy(got)), keyed(want)
    assert list(got) == list(want)
    loose = 0
    for k in want:
        d = np.abs(got[k] - want[k])
        assert d.max() <= 2 * LR * steps_taken, (k, d.max() / LR)
        loose += int((d > 0.01 * LR).sum())
    assert loose <= 1e-3 * sum(w.size for w in want.values()), loose


def test_train_step_matches_the_composed_reference_for_three_steps():
    j_cfg = _f32_smoke()
    j_model = JModel(j_cfg)
    jp, _ = j_model.init_params(jax.random.PRNGKey(0))
    oracle, j_opt = _oracle_step(j_model, 2)
    js = j_opt.init(jp)
    cfg = interop.model_config_from(j_cfg)
    built = steps.build_train_step(cfg, shapes.ShapeSpec("t", "train", S, B), num_microbatches=2)
    assert isinstance(built.optimizer, AdamW) and built.num_microbatches == 2
    tp = interop.tree_from_numpy(jax.device_get(jp))
    ts = built.optimizer.init(tp)
    stream = pipeline.SyntheticTokenStream(pipeline.TokenStreamConfig(cfg.vocab_size, S, B))
    for i in range(3):
        batch = stream.batch(i)
        jp, js, want = oracle(jp, js, {k: jnp.asarray(v) for k, v in batch.items()})
        tp, ts, got = built.fn(tp, ts, pipeline.to_device(batch, "cpu"))
        assert set(got) == set(want) == {"ce", "loss", "grad_norm"}
        for k in want:
            np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-5, err_msg=k)
    assert int(ts.step) == int(js.step) == 3
    _assert_params_close(tp, jax.device_get(jp), 3)
    _assert_params_close(ts.mu, jax.device_get(js.mu), 3)


def test_microbatches_match_the_whole_batch():
    """4 rows as 2 microbatches of 2 or as one: the same step within f32
    rounding (the gradient is the mean of the two halves' means)."""
    cfg = dataclasses.replace(get_config("qwen3-1.7b", smoke=True), dtype="float32")
    params = Model(cfg).init_params(torch.Generator().manual_seed(0))
    batch = pipeline.to_device(pipeline.SyntheticTokenStream(
        pipeline.TokenStreamConfig(cfg.vocab_size, S, B)).batch(0), "cpu")
    out = {}
    for mb in (1, 2):
        built = steps.build_train_step(cfg, shapes.ShapeSpec("t", "train", S, B),
                                       num_microbatches=mb, donate=False)
        out[mb] = built.fn(params, built.optimizer.init(params), batch)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(out[1][2][k].item(), out[2][2][k].item(), rtol=1e-5)
    for a, b in zip(leaves(out[1][0]), leaves(out[2][0])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=2 * LR)
    assert steps.default_microbatches(shapes.SHAPES["train_4k"], get_config("qwen3-1.7b")) == 32


@pytest.mark.parametrize("arch", ["grok-1-314b", "arctic-480b", "qwen3-1.7b", "nemotron-4-15b"])
def test_the_big_model_recipe_on_the_full_configs(arch):
    """Above 2e11 parameters: bf16 parameters, Adafactor, bf16 accumulation,
    decided from the full config without allocating it."""
    cfg = get_config(arch)
    big = cfg.param_counts()["total"] > 2e11
    assert big == (j_get_config(arch).param_counts()["total"] > 2e11) == (arch in (
        "grok-1-314b", "arctic-480b"))
    recipe = steps.train_recipe(cfg)
    assert recipe.big == big
    assert recipe.param_dtype == recipe.accum_dtype == (torch.bfloat16 if big else torch.float32)
    assert isinstance(recipe.optimizer, Adafactor if big else AdamW)
    built = steps.build_train_step(cfg, shapes.SHAPES["train_4k"])
    assert built.recipe == recipe and type(built.optimizer) is type(recipe.optimizer)


def test_big_recipe_trains_bf16_params_with_adafactor(monkeypatch):
    """The recipe on a smoke model (its threshold lowered): bf16 parameters,
    bf16 gradients, Adafactor's factored state, a finite loss."""
    monkeypatch.setattr(steps, "BIG_MODEL_PARAMS", 0)
    cfg = get_config("grok-1-314b", smoke=True)
    params, opt_state, hist = train.train_loop(cfg, shapes.ShapeSpec("t", "train", S, B), 2,
                                               device="cpu", log_every=100)
    assert isinstance(opt_state, AdafactorState) and int(opt_state.step) == 2
    assert {p.dtype for p in leaves(params)} == {torch.bfloat16}
    assert all(np.isfinite(h["loss"]) for h in hist)


# ------------------------------------------------------------ train loop ---

def _loop(tmp_path, name, steps_, **kw):
    cfg = get_config("qwen3-1.7b", smoke=True)
    return train.train_loop(cfg, shapes.ShapeSpec("t", "train", S, B), steps_,
                            ckpt_dir=str(tmp_path / name) if name else None, ckpt_every=2,
                            device="cpu", log_every=100, **kw)


def _assert_bitwise(a, b):
    for x, y in zip(leaves(a), leaves(b)):
        assert torch.equal(x, y)


def test_resumed_train_loop_is_bitwise_the_uninterrupted_run(tmp_path):
    params, state, hist = _loop(tmp_path, "whole", 4)
    _loop(tmp_path, "cut", 2)
    assert store.latest_step(tmp_path / "cut") == 2
    resumed_p, resumed_s, resumed_h = _loop(tmp_path, "cut", 4)
    assert [h["step"] for h in resumed_h] == [2, 3]
    assert [h["loss"] for h in resumed_h] == [h["loss"] for h in hist[2:]]
    _assert_bitwise(resumed_p, params)
    _assert_bitwise((resumed_s.step, resumed_s.mu, resumed_s.nu), (state.step, state.mu, state.nu))
    assert hist[-1]["loss"] < hist[0]["loss"]


class _SigtermAtStep(PreemptionHandler):
    """Sends the process a real SIGTERM when the loop polls at ``at_step``."""

    def __init__(self, at_step):
        super().__init__()
        self.at_step, self.polls = at_step, 0

    @property
    def should_stop(self) -> bool:
        if self.polls == self.at_step:
            os.kill(os.getpid(), signal.SIGTERM)
        self.polls += 1
        return super().should_stop


def test_sigterm_preemption_checkpoints_and_resumes_bitwise(tmp_path):
    whole_p, _, whole_h = _loop(tmp_path, None, 4)
    handler = _SigtermAtStep(3).install()
    try:
        _, _, hist = _loop(tmp_path, "pre", 4, preemption=handler)
    finally:
        handler.uninstall()
    assert [h["step"] for h in hist] == [0, 1, 2]
    assert store.available_steps(tmp_path / "pre") == [2, 3]  # the periodic one and the stop
    resumed_p, _, resumed_h = _loop(tmp_path, "pre", 4)
    assert [h["step"] for h in resumed_h] == [3]
    assert resumed_h[0]["loss"] == whole_h[3]["loss"]
    _assert_bitwise(resumed_p, whole_p)


def _jax_train_state(j_cfg):
    """The reference's params and AdamW state after one composed step."""
    j_model = JModel(j_cfg)
    jp, _ = j_model.init_params(jax.random.PRNGKey(0))
    oracle, j_opt = _oracle_step(j_model, 1)
    batch = j_pipeline.SyntheticTokenStream(j_pipeline.TokenStreamConfig(j_cfg.vocab_size, S,
                                                                         2)).batch(0)
    jp, js, _ = oracle(jp, j_opt.init(jp), {k: jnp.asarray(v) for k, v in batch.items()})
    return jax.device_get(jp), jax.device_get(js)


def test_train_checkpoints_restore_across_packages(tmp_path):
    """A JAX-written ``(params, AdamWState)`` restores into the port's tree
    bitwise, and the port's (written back after a port step) into JAX's."""
    j_cfg = _f32_smoke()
    jp, js = _jax_train_state(j_cfg)
    j_store.save_checkpoint(tmp_path / "jax", 1, (jp, js))
    cfg = interop.model_config_from(j_cfg)
    like_p = Model(cfg).init_params(torch.Generator().manual_seed(5))
    like = (like_p, AdamW().init(like_p))
    (tp, ts), step = store.restore_checkpoint(tmp_path / "jax", None, like, device="cpu")
    assert step == 1 and isinstance(ts, AdamWState) and ts.step.dtype == torch.int32
    want = interop.opt_state_from_numpy(AdamWState, js)
    _assert_bitwise((tp, ts.step, ts.mu, ts.nu),
                    (interop.tree_from_numpy(jp), want.step, want.mu, want.nu))
    assert interop.opt_state_to_numpy(ts)["step"] == 1

    built = steps.build_train_step(cfg, shapes.ShapeSpec("t", "train", S, 2))
    batch = pipeline.to_device(pipeline.SyntheticTokenStream(
        pipeline.TokenStreamConfig(cfg.vocab_size, S, 2)).batch(1), "cpu")
    tp, ts, _ = built.fn(tp, ts, batch)
    store.save_checkpoint(tmp_path / "port", 2, (tp, ts))
    (rp, rs), step = j_store.restore_checkpoint(tmp_path / "port", None, (jp, js))
    assert step == 2 and int(rs.step) == 2
    for got, want in zip(jax.tree.leaves((rp, rs)), leaves((tp, (ts.step, ts.mu, ts.nu)))):
        np.testing.assert_array_equal(np.asarray(got), interop.to_numpy(want))


def test_adafactor_state_crosses_packages_through_interop():
    from repro.optim.adafactor import Adafactor as JAdafactor

    jp = {"w": jnp.ones((4, 6)), "b": jnp.ones((6,))}
    js = jax.device_get(JAdafactor().update({"w": jnp.full((4, 6), 0.5), "b": jnp.ones((6,))},
                                            JAdafactor().init(jp), jp)[1])
    ts = interop.opt_state_from_numpy(AdafactorState, js)
    back = interop.opt_state_to_numpy(ts)
    for name in ("v_row", "v_col", "v_full"):
        for k in ("w", "b"):
            np.testing.assert_array_equal(back[name][k], np.asarray(getattr(js, name)[k]))
    assert int(back["step"]) == 1


def test_train_cli_descends_on_the_cpu_and_refuses_a_missing_gpu(monkeypatch, capsys):
    assert train.main(["--arch", "qwen3-1.7b", "--smoke", "--steps", "12",
                       "--device", "cpu"]) == 0
    first, last = capsys.readouterr().out.strip().splitlines()[-1].split("loss ")[1].split(" -> ")
    assert float(last) < float(first)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        train.main(["--arch", "qwen3-1.7b", "--smoke", "--steps", "1"])


# ------------------------------------------------------------ the guard ---

def test_every_kernel_wrapper_refuses_inputs_that_require_grad():
    """On the CPU path's entry too: a wrapper never lets a loss through it
    lose its gradient; under ``torch.no_grad`` the same call runs."""
    q = torch.randn(1, 4, 2, 16, requires_grad=True)
    k = torch.randn(1, 4, 2, 16)
    kl = torch.tensor([4], dtype=torch.int32)
    calls = [
        lambda: fa_ops.flash_attention(q, k, k),
        lambda: da_ops.decode_attention(q[:, :1], k, k, kl),
        lambda: da_ops.decode_attention_partials(q[0, :1], k[0, :, :1].transpose(0, 1).expand(
            1, 4, 16), k[0, :, :1].transpose(0, 1).expand(1, 4, 16), kl, num_splits=2),
        lambda: ssd_ops.intra_chunk(q[..., :8].contiguous(), torch.rand(1, 4, 2),
                                    -torch.ones(1, 2), torch.randn(1, 4, 8),
                                    torch.randn(1, 4, 8), chunk=4),
    ]
    for call in calls:
        with pytest.raises(NoBackwardError, match="no backward pass"):
            call()
        with torch.no_grad():
            call()
    state = torch.rand(8, 2, requires_grad=True)
    with pytest.raises(NoBackwardError):
        es_ops.fused_benefits_batched(state, state, torch.zeros(8, 2, dtype=torch.int32),
                                      state[:, :1].T, None, torch.ones(2, 2))
