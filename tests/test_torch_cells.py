"""The reference's serve cells through the port's one-device steps, on the CPU.

* ``launch.steps.build_prefill_step`` / ``build_decode_step`` without a
  mesh, on the smoke configs of the five architectures the long cells run
  (qwen3, mamba2, hymba, h2o-danube, gemma2): the prefill allocates its
  cache at ``max_len = seq_len`` (the reference's ``build_prefill_step``),
  the decode step takes a ``fill_cache``d cache of ``seq_len`` rows at
  length ``seq_len - 1`` — both held against the reference's
  ``Model.prefill`` / ``decode_step`` on the same weights (``interop``) and
  the same cache contents: logits within 2e-5 (f32; the zoo parity
  tolerance of ``test_torch_zoo.py``), argmax tokens equal.
* ``launch.cells``: ``fill_cache`` is deterministic for a seed, and
  ``one_card_cell`` gives each of the eight cells the batch, depth and
  ``reduced`` list that the bytes reckoned here give.
* RoPE at long positions, port against the reference.
* The mesh-free decode's split route (``decode_attention.ops.decode_route``)
  against the reference's decode oracle, and the route each cell's shape
  takes.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.archs import get_config as j_get_config
from repro.kernels.decode_attention import ref as j_da_ref
from repro.models import layers as j_layers
from repro.models import transformer as j_tf
from repro.models.model import Model as JModel
from repro_torch import interop
from repro_torch.configs.archs import get_config
from repro_torch.configs.shapes import SHAPES, ShapeSpec
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.launch import cells
from repro_torch.launch import steps as st
from repro_torch.models import layers
from repro_torch.models import transformer as tf
from test_torch_threads import one_torch_thread  # noqa: F401

ARCHS = ("qwen3-1.7b", "mamba2-370m", "hymba-1.5b", "h2o-danube-1.8b", "gemma2-9b")
SEQ, BATCH = 48, 2  # past the smoke windows (16): the local layers' window binds
TOL = 2e-5


def _models(arch):
    import jax

    j_cfg = dataclasses.replace(j_get_config(arch, smoke=True), dtype="float32",
                                attn_impl="dense")
    j_model = JModel(j_cfg)
    j_params = jax.device_get(j_model.init_params(jax.random.PRNGKey(0))[0])
    cfg = dataclasses.replace(interop.model_config_from(j_cfg), attn_impl="kernel")
    return j_model, j_params, cfg, interop.tree_from_numpy(j_params)


def _hold(got: torch.Tensor, want, label: str) -> None:
    want = np.asarray(want).astype(np.float32)
    got = got.numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL, err_msg=label)
    assert np.array_equal(got.argmax(-1), want.argmax(-1)), label


@pytest.mark.parametrize("arch", ARCHS)
def test_one_device_prefill_step_matches_jax(arch):
    """The one-device prefill step allocates its cache at ``seq_len`` rows and
    matches the reference's ``Model.prefill(max_len=seq_len)``."""
    j_model, j_params, cfg, params = _models(arch)
    shape = ShapeSpec("prefill_32k-smoke", "prefill", SEQ, BATCH)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (BATCH, SEQ)).astype(np.int32)
    want, j_cache = j_model.prefill(j_params, {"tokens": jnp.asarray(tokens)}, max_len=SEQ)
    step = st.build_prefill_step(cfg, shape, device="cpu")
    assert step.args is None and step.mesh is None
    got, cache = step.fn(params, {"tokens": torch.from_numpy(tokens).long()})
    _hold(got, want, f"{arch} prefill")
    assert int(cache.length) == int(j_cache.length) == SEQ
    for mine, theirs in zip(cache.kv_k + cache.ssm_h, j_cache.kv_k + j_cache.ssm_h):
        assert (mine is None) == (theirs is None)
        if mine is not None:
            assert mine.shape == tuple(theirs.shape)
            np.testing.assert_allclose(mine.numpy(), np.asarray(theirs), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_one_device_decode_step_matches_jax_on_a_filled_cache(arch):
    """The decode step over a ``fill_cache``d cache of ``seq_len`` rows at
    ``seq_len - 1`` writes the last row and attends over every row, as the
    reference's ``decode_step`` on the same cache contents."""
    j_model, j_params, cfg, params = _models(arch)
    shape = ShapeSpec("decode_32k-smoke", "decode", SEQ, BATCH)
    cache = tf.init_model_cache(cfg, BATCH, SEQ, cfg.activation_dtype, device="cpu")
    cache = cells.fill_cache(cache, torch.Generator().manual_seed(3), SEQ - 1)

    def arrays(stacks):  # copies: the port's step writes its cache in place
        return tuple(None if t is None else jnp.asarray(interop.to_numpy(t).copy())
                     for t in stacks)

    j_cache = j_tf.ModelCache(kv_k=arrays(cache.kv_k), kv_v=arrays(cache.kv_v),
                              ssm_conv=arrays(cache.ssm_conv), ssm_h=arrays(cache.ssm_h),
                              length=jnp.asarray(SEQ - 1, dtype=jnp.int32))
    token = np.random.default_rng(2).integers(0, cfg.vocab_size, (BATCH, 1)).astype(np.int32)
    want, j_after = j_model.decode_step(j_params, jnp.asarray(token), j_cache)
    want = np.asarray(want)  # computed before the port's step writes the cache
    step = st.build_decode_step(cfg, shape, device="cpu")
    got, after = step.fn(params, torch.from_numpy(token).long(), cache)
    _hold(got, want, f"{arch} decode at {SEQ - 1}")
    assert int(after.length) == int(j_after.length) == SEQ
    for stack in after.kv_k:
        if stack is not None:  # the new row landed in the cache's last row
            assert bool((stack[:, :, SEQ - 1] != 0).any())
    other = tf.init_model_cache(cfg, BATCH, SEQ + 8, cfg.activation_dtype, device="cpu")
    if any(t is not None for t in other.kv_k):  # the cell's cache has seq_len rows
        with pytest.raises(ValueError, match="rows"):
            step.fn(params, torch.from_numpy(token).long(), other)


def test_one_device_steps_run_on_the_card_unless_asked(monkeypatch):
    """Without ``device`` the one-device steps resolve to the card, and raise
    with no GPU; nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("qwen3-1.7b", smoke=True)
    for build, name in ((st.build_prefill_step, "prefill_32k"),
                        (st.build_decode_step, "decode_32k")):
        with pytest.raises(RuntimeError, match="cuda"):
            build(cfg, SHAPES[name])
        assert build(cfg, SHAPES[name], device="cpu").fn is not None


def test_fill_cache_is_deterministic_for_a_seed():
    """The same seed writes the same values; another seed others; rows at and
    past ``length`` stay as they were; the cache comes back at ``length``."""
    cfg = get_config("hymba-1.5b", smoke=True)

    def filled(seed):
        cache = tf.init_model_cache(cfg, 2, 40, torch.bfloat16, device="cpu")
        return cells.fill_cache(cache, torch.Generator().manual_seed(seed), 33)

    a, b, c = filled(5), filled(5), filled(6)
    assert int(a.length) == 33 and a.length.dtype == torch.int32
    for x, y, z in zip(a.kv_k + a.kv_v + a.ssm_conv + a.ssm_h,
                       b.kv_k + b.kv_v + b.ssm_conv + b.ssm_h,
                       c.kv_k + c.kv_v + c.ssm_conv + c.ssm_h):
        assert torch.equal(x, y) and not torch.equal(x, z)
    for stack in a.kv_k + a.kv_v:
        assert bool((stack[:, :, :33] != 0).all()) and not stack[:, :, 33:].any()
    with pytest.raises(ValueError, match="exceeds"):
        cells.fill_cache(tf.init_model_cache(cfg, 1, 8, torch.bfloat16, device="cpu"),
                         torch.Generator(), 9)


def _cache(cfg, shape, batch) -> int:
    """Bytes of the KV / SSM cache from its shapes: bf16 K / V rows and conv
    tails, f32 states."""
    total, groups = 0, cfg.num_layers // len(cfg.layer_pattern)
    for mixer in cfg.layer_pattern:
        if mixer in ("global", "local", "hymba"):
            total += groups * 2 * batch * shape.seq_len * cfg.num_kv_heads * cfg.head_dim * 2
        if mixer in ("mamba", "hymba"):
            s = cfg.ssm
            di = s.d_inner(cfg.d_model)
            total += groups * batch * ((s.conv_width - 1) * (di + 2 * s.state_dim) * 2
                                       + s.num_heads(cfg.d_model) * s.head_dim * s.state_dim * 4)
    return total


def _prefill_figure(cfg) -> float:
    """The module's bytes a token and unit of width for ``cfg``: the measured
    peak of each family its layers belong to (a hymba layer is both), the
    larger, plus the room."""
    peaks = set()
    for mixer in cfg.layer_pattern:
        if mixer in ("mamba", "hymba"):
            peaks.add(cells.PREFILL_BYTES_PER_WIDTH["ssm"])
        if mixer != "mamba":
            peaks.add(cells.PREFILL_BYTES_PER_WIDTH["attention"])
    return max(peaks) + cells.PREFILL_ROOM_BYTES_PER_WIDTH


def _reckoned(cfg, shape, batch) -> int:
    """Bytes of one cell, reckoned here: every parameter in bf16 (the norms
    and SSM vectors, f32 in the tree, are under 1% of any of these models),
    the cache, and the activation margin the module states."""
    if shape.kind == "prefill":
        act = batch * shape.seq_len * _prefill_figure(cfg) * cells.widest_activation(cfg)
    else:
        act = cells.DECODE_FIXED_BYTES + batch * cfg.vocab_size * 4 * cells.DECODE_LOGIT_COPIES
    return 2 * cfg.param_counts()["total"] + _cache(cfg, shape, batch) + act


# arch, shape -> (batch, layers): what one 80 GB card holds (PERF.md §4)
EXPECTED = {("qwen3-1.7b", "prefill_32k"): (8, 28), ("mamba2-370m", "prefill_32k"): (32, 48),
            ("qwen3-1.7b", "decode_32k"): (16, 28), ("mamba2-370m", "decode_32k"): (128, 48),
            ("hymba-1.5b", "long_500k"): (1, 32), ("h2o-danube-1.8b", "long_500k"): (1, 24),
            ("gemma2-9b", "long_500k"): (1, 16), ("mamba2-370m", "long_500k"): (1, 48)}


@pytest.mark.parametrize("arch,shape", cells.SERVE_CELLS)
def test_one_card_cell_sizes_each_serve_cell(arch, shape):
    cell = cells.one_card_cell(arch, shape)
    spec = SHAPES[shape]
    assert (cell.batch, cell.cfg.num_layers) == EXPECTED[arch, shape]
    assert cell.cache_bytes == _cache(cell.cfg, spec, cell.batch)
    mine = _reckoned(cell.cfg, spec, cell.batch)
    assert abs(cell.total_bytes - mine) <= 0.01 * mine
    assert mine <= cells.CARD_BYTES
    full = get_config(arch)
    period = len(full.layer_pattern)
    if cell.batch < spec.global_batch:  # twice the batch does not fit
        assert _reckoned(cell.cfg, spec, 2 * cell.batch) > cells.CARD_BYTES
        assert any(r.startswith(f"global batch {spec.global_batch} -> {cell.batch}")
                   for r in cell.reduced)
    if cell.cfg.num_layers < full.num_layers:  # one period more does not fit
        deeper = dataclasses.replace(full, num_layers=cell.cfg.num_layers + period)
        assert _reckoned(deeper, spec, 1) > cells.CARD_BYTES
        assert cell.cfg.num_layers % period == 0
        assert any(r.startswith(f"layers {full.num_layers} -> {cell.cfg.num_layers}")
                   for r in cell.reduced)
    else:
        assert cell.cfg == full
    if (cell.batch, cell.cfg.num_layers) == (spec.global_batch, full.num_layers):
        assert cell.reduced == ()


@pytest.mark.parametrize("arch,families", [("qwen3-1.7b", ("attention",)),
                                           ("mamba2-370m", ("ssm",)),
                                           ("hymba-1.5b", ("attention", "ssm")),
                                           ("gemma2-9b", ("attention",))])
def test_prefill_reckoning_takes_each_family_s_measured_peak(arch, families):
    """A prefill's bytes a token and unit of width: its families' measured
    peak (the larger where a model has both) plus the unchanged room of 5."""
    cfg = get_config(arch)
    want = max(cells.PREFILL_BYTES_PER_WIDTH[f] for f in families) + 5.0
    assert cells.PREFILL_ROOM_BYTES_PER_WIDTH == 5.0
    assert cells.prefill_bytes_per_width(cfg) == want == _prefill_figure(cfg)
    spec = SHAPES["prefill_32k"]
    assert cells.activation_bytes(cfg, spec, 2) == int(
        2 * spec.seq_len * want * cells.widest_activation(cfg))


def test_mamba2_prefill_32k_runs_at_the_reference_batch():
    """With the SSD's recurrence a kernel (no stacked states) the SSM
    family's measured peak is below the loop's 15.2 bytes a token and unit,
    and mamba2-370m's prefill_32k fits one card at the global batch of 32,
    cut nowhere; qwen3-1.7b's stays at B 8 (its 30 GB cache)."""
    assert cells.PREFILL_BYTES_PER_WIDTH["ssm"] < 15.2
    cell = cells.one_card_cell("mamba2-370m", "prefill_32k")
    assert (cell.batch, cell.reduced) == (32, ()) and cell.total_bytes <= cells.CARD_BYTES
    assert cells.one_card_cell("qwen3-1.7b", "prefill_32k").batch == 8


def test_one_card_cell_refuses_what_the_reference_skips():
    with pytest.raises(ValueError, match="skip"):
        cells.one_card_cell("qwen3-1.7b", "long_500k")
    with pytest.raises(ValueError, match="serve cells"):
        cells.one_card_cell("qwen3-1.7b", "train_4k")


# The port's frequencies that differ from the reference's on the CPU, each by
# one f32 ulp (theta ** (i / half) rounds apart in the two frameworks): D 128
# at theta 1e6, index 37; D 256 at theta 1e4, index 111, and at 1e6, index 74.
# At position 524,287 that ulp moves the angle by up to ~1.6e-5 rad, so a
# rotated value by up to that many times the input's largest magnitude.
ROPE_TOL = 2e-5  # of the input's largest magnitude
ROPE_POSITIONS = (0, 4095, 32767, 524287)


@pytest.mark.parametrize("d", (64, 80, 128, 256))
@pytest.mark.parametrize("theta", (1e4, 1e6))
def test_rope_matches_jax_at_long_positions(d, theta):
    want = np.asarray(j_layers.rope_frequencies(d, theta))
    got = layers.rope_frequencies(d, theta).numpy()
    ulps = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32))
    assert ulps.max() <= 1 and (ulps > 0).sum() <= 1
    x = np.random.default_rng(d).standard_normal((2, len(ROPE_POSITIONS), 3, d)).astype(
        np.float32)
    pos = np.broadcast_to(np.array(ROPE_POSITIONS, dtype=np.int32), (2, len(ROPE_POSITIONS)))
    want = np.asarray(j_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))
    got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos.copy()), theta).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ROPE_TOL * np.abs(x).max())


# b, skv, h, kv, d, kv_len, window (the kernel's convention), softcap
SPLIT_CASES = [(2, 512, 4, 2, 64, 512, None, None), (1, 1024, 8, 2, 128, 700, None, 50.0),
               (1, 768, 4, 1, 80, 768, 200, None)]


@pytest.mark.parametrize("case", SPLIT_CASES)
def test_split_decode_route_matches_the_reference_oracle(case, monkeypatch):
    """Past ``SPLIT_FROM`` keys a fused block the mesh-free decode takes the
    split route (the partials over ``default_num_splits`` splits, then the
    combine): bf16 within 2e-2 of the reference's ``reference_decode``."""
    b, skv, h, kv, d, kv_len, window, cap = case
    monkeypatch.setattr(da_ops, "SPLIT_FROM", 16)
    assert da_ops.decode_route(torch.bfloat16, d, b * kv, skv, window) == "split"
    assert da_ops.decode_route(torch.float32, d, b * kv, skv, window) == "fused"
    rng = np.random.default_rng(skv)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((b, 1, h, d), (b, skv, kv, d), (b, skv, kv, d)))
    kl = np.array([kv_len], dtype=np.int32)
    want = np.asarray(j_da_ref.reference_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                                jnp.asarray(kl), softcap=cap, window=window))
    da_ops.reset_counts()
    got = da_ops.decode_attention(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)),
                                  torch.from_numpy(kl), softcap=cap, window=window)
    assert da_ops.PLAIN_CALLS == {da_ops.KERNEL: 1, da_ops.FUSED: 0}
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2, atol=2e-2)


def test_decode_route_takes_split_only_at_the_long_cells():
    """hymba's and gemma2's global layers at 524,288 keys (B 1: the fused
    cluster at its cap, 65,536 keys a block) take the split route; qwen3 at
    B 16 over 32,768 keys (128 (b, kv head) pairs fill the card), danube's
    and gemma2's windows and every shorter shape a served path runs (the
    qwen3 decode at B 8 over 4,096 rows, the zoo's at B 1 over ~4,616)
    stay fused."""
    bf16 = torch.bfloat16
    route = da_ops.decode_route
    assert route(bf16, 64, 5, 524288, None) == "split"
    assert route(bf16, 256, 8, 524288, None) == "split"
    assert route(bf16, 64, 5, 65536, None) == "split"  # 8,192 keys a block
    assert route(bf16, 64, 5, 32768, None) == "fused"
    assert route(bf16, 128, 128, 32768, None) == "fused"
    assert route(bf16, 80, 8, 524288, 4097) == "fused"
    assert route(bf16, 256, 8, 524288, 4097) == "fused"
    for bkv, skv in ((64, 4096), (8, 4616), (5, 2080), (8, 4128), (4, 3424)):
        assert route(bf16, 128, bkv, skv, None) == "fused", (bkv, skv)
