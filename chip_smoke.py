"""On-card smoke test of the PyTorch/H100 port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one NVIDIA GPU (Hopper, sm_90a) and the CUDA toolkit's nvcc.  Phases,
in order; any failure raises and the script exits non-zero:

1. environment: the card's name and power limit, torch/CUDA versions, and
   the build of every kernel on the main paths from this checkout's sources
   (one nvcc per source, started together), with each kernel's ptxas summary;
2. kernels vs plain: both batched ``enrich_score`` kernels against their
   plain PyTorch versions on the same card tensors at the main path's shape
   (C = 1<<20 rows, P = 4, F = 4, Q = 8 tenant slots), f32 and bf16 rows, a
   learned decision table and an edge-bin fixture, and the single-query
   kernel at the operator's shape (N = 1<<20 objects, P = 2, F = 4, the
   quickstart's learned table and an edge-bin fixture, ~30% of objects no
   candidates) — ``next_fn``, ``cost``, ``benefit`` and ``est_joint`` must be
   bitwise equal — and their times; then each scoring kernel's "global"
   table route (``GLOBAL_CASES``, 10 bins: best mode at C 1M, P 4, F 8, Q 8
   in bf16 and f32 with the 8-function world's learned table, table mode
   at C 262,144, P 16, F 8, Q 8, the single-query kernel at N 1M, P 11, F
   8, and best mode past eight functions at C 1M, P 4, Q 8 in bf16 and f32
   with the analytic fallback table: F 10 on the unrolled lane kernel, F 11
   on the wide kernel), bitwise against the plain twin on plain and edge-bin rows and timed
   beside its bound (the table read once) and the plain twin, best mode's
   with the benefit divisions its division screen does on those inputs
   (``ref.best_screen``, the kernels' computation in PyTorch), and both
   routes on the same inputs, uncounted, at the main paths' shapes, the
   largest tables that still fit and each side of each mode's crossover
   (``ROUTE_PAIR_CASES``); all timed with
   CUDA events around runs of 10 calls enqueued behind a device sleep, so
   that host launch overhead does not pace them (median of 25 runs after
   warm-up; a plain twin of the global route 5 runs of 2), beside the
   bound; the flash kernel
   (``FA_CASES``); the decode kernels at qwen3-1.7b decode (B 8, H 16, KV 8,
   D 128, kv_len 2048 of a 4096 cache, bf16 and f32, and a window +
   softcap case): the fused kernel (the model's route: splits over the
   live keys, the combine through a cluster, one launch) within 2e-5 of
   its twin in f32 and 2e-2 of the oracle in bf16, the partials kernel
   (splits over the cache length; the model mesh's decode route) within
   2e-5 of its twin in the form ``partials_route`` names — "tc" for bf16
   at D 64 / 80 / 128 / 256 (the fused kernel's tensor-core body, P in
   three bf16 terms), "simt" otherwise — and on the tc form's inputs its
   simt form (uncounted), each timed beside its own bound, with SDPA over
   the live keys as the yardstick; and the SSD intra-chunk kernels at the
   mamba2-370m prefill shape (B 2, S 4096, H 32, P 64, N 128, chunk 256,
   bf16: the "tc" route, and the "simt" kernel on the same inputs,
   uncounted, which must be the slower) and the cascade's (512
   lanes x 8 tokens, with and without the final state: the "packed"
   route), every output within 1e-4 of its largest magnitude; then the
   SSD inter-chunk kernel (``csrc/ssd_inter_chunk.cu``: the recurrence over
   chunks, adding into y_intra in place) on the intra-chunk kernel's
   outputs at ``INTER_CASES`` (the mamba2 and hymba prefills, a packed
   cascade block with a state, eight packed chunks with none, h0 without
   the final state), y and the final state within 1e-4 of their largest
   magnitudes against its twin (the loop over chunks), timed beside its
   bound and the twin; then the Mamba-2 mixer's two kernels
   (``csrc/ssm_mixer.cu``: the front — causal conv + SiLU, the gate, dt's
   softplus, the conv tail — and the gated norm) at ``MIXER_CASES`` (phase
   7's mamba2 prefill, hymba's prefill, both cascade trunks, a mamba2
   decode step at B 128, the mamba2 prefill_32k layer at B 32, its twins
   two rows at a time): the front bitwise its twin (the eager chain), the
   norm within one ulp (the share of values apart printed), each beside a
   control that must miss (the conv's taps reversed, the norm without its
   gate), timed beside its bytes bound and its twin.  The flash
   cases run its four kernels, as ``kernel.route`` picks them: for bf16
   "tc" (wgmma + TMA, >= 64 query rows, D 64 / 80 / 128 / 256), and at D
   64 / 128 with fewer rows "split" (at most 8 query rows a kv head over
   more than 64 keys: the keys over a cluster of blocks; held against its
   own twin, the shares' partials and their combine) and "short"
   (mma.sync, one 16-row tile a warp: the cascade's 8-token blocks), else
   "simt" (f32, other head dims), each within its tolerance of the twin
   (ragged tc tiles and rows with no live key at every tc head dim; at D
   80 / 128 / 256 and gemma2's global shape also with q scaled so that the
   scores reach the softcap, where the tc kernel without its cap must
   differ from the twin beyond the tolerance, and a tc build with
   libdevice's accurate tanhf, uncounted, prints its distance too); the
   cascade shape, the causal S 4096 case and the qwen3-1.7b prefill shape
   (B 8, Sq 2048 over a 4096-row cache, kv_len 2048) are timed beside SDPA
   over the live keys, the bound and the kernels the route did not pick
   (where they take the dtype and head dim; held against the twin too, and
   not counted: at the cascade's shape the short kernel must be no slower
   than the simt kernel it replaced); then every attention shape phase 7b
   gives the kernels
   (``ZOO_FA``: seamless's non-causal encoder, cross-attention prefill,
   cross-attention decode on "split" (beside the short kernel on the same
   inputs, uncounted: split must be the faster) and G 1 decoder, hymba's G
   5 cascade trunk and prefill, the G 6 / 4 / 7 prefills
   of nemotron, llava and grok-1 / arctic, h2o-danube's D 80 and gemma2's
   D 256 local and global layers on the tc kernel, each beside the simt
   kernel on the same inputs, and gemma2's global layer, at both q scales,
   beside the tc kernel without its softcap and with the accurate tanhf,
   all uncounted), every decode shape of
   it (``ZOO_DA``: the fused kernel's tc form at G 4 D 80 and G 2 D 256 in
   bf16, each beside the simt form on the same inputs, uncounted, which
   must be the slower, and the simt form in f32 at its 64 values a thread;
   G 1 / 4 / 5 / 6 / 7 on the tc form; the partials kernel at every one of
   these groups, G 6 / 7 at D 128 included, in its route's form beside its
   simt form, uncounted)
   and hymba's SSD at N 16 (tc at its prefill, beside the simt kernel on
   the same inputs, uncounted, which must be the slower; packed in its
   cascade trunk), each timed beside its bound and the library call that computes
   the same function: SDPA (with a window mask), or for a softcap the
   compiled ``flex_attention`` (a tanh score_mod, a causal / window block
   mask); and each softcap where it binds (q drawn x12 / x16 against caps
   of 30 / 50, so |s / cap| reaches ~2): the short and split kernels at D
   64 / 128, the simt kernel in f32 and bf16, the fused decode kernel in
   its tc form (bf16 D 64 / 80 / 128 / 256, gemma2's local and global
   shapes) and simt form (f32 D 80 / 128 / 256) and the partials kernel
   (its route's form and, on tc inputs, its simt form), each within its
   tolerance (f32's
   scaled by q's factor: the scores' rounding grows with them) and the
   same kernel without its cap (an uncounted launch) beyond it;
3. CPU vs GPU session: one churn trace at capacity 4096 with 4 tenants, in
   both scoring modes, through ``EngineSession(device="cpu")`` (plain path)
   and ``device="cuda"`` (kernels) — per-slot plans, merged plans,
   want-bits and answer sets must be equal epoch by epoch, spend and
   per-slot attribution within rtol 1e-5 (f32 sums run in another order on
   the card); then the model-cascade bank with the reduced f32 trunk, built
   on the CPU and copied to the card: ``execute`` on the CPU (plain twins)
   and on the card (kernels) over the same merged plans agree within 1e-5,
   the first epoch's plans are equal, and later plans and answer sets are
   compared (a divergence is printed with its epoch); the same with the
   reduced f32 mamba2 trunk, where plans and answer sets must be equal on
   every epoch; then the paper's
   operator on the quickstart query and corpus at N = 4,096 for 24 epochs,
   built on the CPU and run with ``device="cpu"`` and ``device="cuda"``:
   the kernel route (``benefit_fn=fused_benefits``) and the session facade
   (default scoring) — plans and answer sets equal epoch by epoch, spend
   within rtol 1e-5; and the reduced f32 qwen3 and mamba2 models: prefill
   of 96 tokens x 4 and 8 greedy decode steps on the CPU and the card,
   logits within 1e-3 and greedy tokens equal; then the reduced bf16
   qwen3 (head_dim 128, GQA 2 / 1, 96-token prefill) and mamba2 (chunk 256,
   512-token prefill) models, whose widths take the bf16 routes (flash
   "tc", the fused decode, SSD "tc": asserted), the card fed the CPU's
   greedy tokens, logits within 2x the CPU bf16 run's distance from f32;
   the same for the model zoo's reduced bf16 gemma2 (D 256, local / global,
   both softcaps), h2o-danube (D 80), hymba (GQA 5 beside SSD heads of state
   16) and seamless (an encoder over 128 frames, cross-attention); the MoE
   smoke models (grok-1, Arctic) CPU vs card in f32 with the router's
   choices equal on every layer and step and logits within 2e-4 (in bf16
   the choices that flip are printed only); then the cascade bank with the
   reduced bf16 qwen3 trunk (D 128, 2 query heads over 1 KV head: the "short" route, asserted), built on the CPU and
   copied to the card, ``execute`` over the same merged plans on both and on
   an f32 CPU copy: the card's probabilities within 2x the bf16 CPU run's
   distance from f32;
4. the main path at full size: the session server (``repro_torch.launch.
   serve``: 524,288 rows growing to 1,048,576, 8 tenant slots, bf16
   substrate, best-mode scoring) serves
   ``admit:2;admit:3;admit:2;run:8;ingest:524288;admit:4;run:8;retire:0;run:8``,
   then the grown state runs 8 more epochs in the paper's table mode.  Every
   kernel must have launched on this path, the plain versions never, the
   chunk programs stay within the tier bound, the invoices fold to
   ``cost_spent`` bit for bit, every epoch charges new enrichment, the mean
   entropy of the initial rows falls and E(F) stays a probability.
   (Mean E(F) itself FALLS over these epochs, as it does in the reference:
   the 0.5 prior overstates 0.3-selective predicates, so early enrichment
   mostly moves probability mass down.);
4a. eight tagging functions, whose best-mode table (P 4, 2^8 states, 10
   bins: 327,680 B) outgrows a block's shared memory and takes the scoring
   kernel's "global" table route: phase 3's churn trace through a CPU and
   a card session (plans, want-bits, answers and ``answer_digest`` equal),
   then the session server at 1,048,576 rows serves
   ``admit:2;admit:3;admit:2;run:4``: every launch on the global route, no
   plain call, invoices folding bit for bit, every epoch charging; then the
   same with ten tagging functions (``SESSION10_*``, a table of 2^10 states:
   1,638,400 B), every best-mode launch on the global route at F 10;
4b. serving robustness at the same size (phase 4's world, ``MAIN_TRACE``),
   each part against a lockstep control from the same seed: ``overlap=True``
   in turns with lockstep (digests equal, no more chunk programs, epochs/s
   of both), the pipeline's event staging (host ingest rows: the pinned
   copy path) under ``torch.cuda.set_sync_debug_mode("error")``, and 8
   table-mode epochs on the grown state through a pipeline (kernel 1); the
   ingest through ``StreamingIngest`` (65,536-row batches: 4 slots
   ``block`` under overlap, 2 slots ``spill`` lockstep; digests equal direct
   ingest) and the feed's rate beside the bare pinned copy's; a preemption
   from the boundary hook at chunk 5 of 2-epoch chunks, a checkpoint every
   2 chunks, restore on a fresh session and resume (digests and
   ``epochs_total`` equal; bytes, save and restore ms); the supervisor:
   ``kill:w1@chunk:4`` on 2 shards ends healthy with ``shrinks == [[2,
   1]]`` and the 2-shard control's digests, ``raise:p1.f2@chunk:4`` on one
   ends degraded with ``quarantined == [[1, 2]]``; then overlap + streaming
   and checkpoint / resume at phase 3's size on the CPU and the card (each
   bitwise its device's lockstep run, answers equal across devices, spend
   within rtol 1e-5).  The scoring kernels launch in every part and the
   plain versions never;
5. the cascade main path at full width: ``build_cascade_session_server`` on
   the card with the full 28-layer qwen3-1.7b trunk (2,048 objects + 512 to
   train on, 3 predicates x 3 levels, 8 tenant slots, plan size 64, f32
   substrate, best mode) serves ``CASCADE_TRACE``.  The flash kernel must
   launch 28 times per epoch that ran the trunk (at least 4 such epochs),
   the plain twins never; chunk programs within the bound, invoices fold
   bit for bit, every epoch charges, probabilities finite and in [0, 1];
   every flash launch goes by the "short" route; then the same with the
   48-layer mamba2-370m trunk (d_model 1024): the SSD kernel launches 48
   times per trunk epoch, all by the "packed" route, the flash kernel never;
   then with the 32-layer hymba-1.5b trunk (d_model 1600, 25 / 5 heads of
   64 beside 50 SSD heads of state 16): 32 flash launches, all "short", and
   32 SSD launches, all "packed", per trunk epoch; both SSM trunks launch
   the mixer's front and gated norm once a layer and trunk epoch;
6. the operator main path at full size: the quickstart query and corpus at
   N = 1,048,576 (+1,024 rows to train on), ``OperatorConfig()`` defaults
   (plan size 256, table mode, exact answers), the ``preprocess_cheapest``
   warm start; 32 epochs of ``op.run`` on the kernel route, then 32 of the
   same operator through the session facade.  The single-query kernel must
   launch once per kernel-route epoch and the table kernel on every facade
   epoch, the plain versions never; every epoch charges spend, the mean
   entropy falls, E(F) stays in [0, 1];
7. the two other serve entry points on the card: the single-query server
   and ``--queries 4`` (best mode: the best-mode kernel launches); both
   return 0; then ``Model.prefill`` + 32 greedy ``decode_step``s at full
   width: qwen3-1.7b over 2,048 tokens x 8 (28 flash launches in the
   prefill, all by the "tc" route; 28 fused decode launches a step and no
   partials kernel) and mamba2-370m over 4,096 tokens x 2 (48 SSD launches
   in the prefill, all by the "tc" route, and 48 of the inter-chunk kernel;
   decode runs ``ssd_step``; the mixer's front and gated norm 48 times in
   the prefill and in every step), with
   ms per prefill and per step and peak memory;
7b. the model zoo at published widths (``ZOO_ARCHS``; random bf16 weights
   built on the card one f32 matrix at a time, B 1, 16 greedy decode steps,
   memory freed after each): nemotron-4-15b (32 layers, untied) over 2,048
   tokens, gemma2-9b (42) and h2o-danube-1.8b (24) over 4,608 (past their
   4,096-key window), hymba-1.5b (32) over 2,048, llava-next-mistral-7b (32)
   over 2,880 random image embeds + 512 tokens, seamless-m4t-large-v2 (24 +
   24) over 1,024 random frames + 512 tokens, and grok-1-314b and
   arctic-480b at full width with the depth cut to what one 80 GB card
   holds (4 of 64 and 2 of 35 layers) over 512 tokens: finite logits, every
   launch on the route its head dim picks (every prefill "tc", D 80 / 256
   included; every decode step's self-attention on the fused kernel's tc
   form, gemma2's and h2o-danube's included; seamless's cross-attention a
   step on "split"; hymba's 32 prefill SSD launches on "tc", none on
   "simt"), no plain call; prefill ms (tokens/s), median step ms and peak
   memory;
7c. training (no kernel runs: the wrappers refuse inputs that require
   grad): the qwen3, mamba2 and grok-1 smoke models in f32 on the CPU and
   the card from the same weights and batches — loss, metrics, grad norm,
   every gradient leaf, then 2 AdamW steps through ``build_train_step``;
   qwen3-1.7b at full width (28 layers, d 2,048, 1,720,451,072 random f32
   parameters, bf16 activations) through ``launch.train.train_loop``: 4
   AdamW steps of 8 x 4,096 tokens (train_4k's length; its batch of 256 cut
   to 8, as 2 microbatches of 4) on the chunked attention engine with
   remat — ms a step (host clock, synchronised; the median of steps 2-4),
   tokens/s, peak memory and every loss, the losses finite and the last
   below the first, no kernel launched, the chunked engine counted; then,
   in a child process under ``torch.use_deterministic_algorithms(True)``
   with ``CUBLAS_WORKSPACE_CONFIG`` set before cuBLAS starts, the same
   width cut to 4 layers checkpointed at step 2 and resumed in a fresh
   loop: steps 3-4 and every parameter and moment bitwise the uninterrupted
   run's;
8. the model mesh, in a child process (so the main process holds no
   process group): a one-rank NCCL group (never gloo on the card) and a
   (1, 1) ("data", "model") mesh; qwen3-1.7b at full width (random bf16
   weights, the kernel route) through ``build_prefill_step`` (8 x 2,048
   into a 4,096-row cache: 28 tc flash launches on the local heads) and 32
   ``build_decode_step``s fed the mesh-free run's greedy tokens (the cache
   sharded on its rows: 28 x 32 partials launches, all on the tc form,
   then the combine; no
   fused launch), and mamba2-370m through ``build_prefill_step`` (2 x
   4,096: 48 SSD tc launches), each against the mesh-free ``prefill`` /
   ``decode_step`` on the same weights, and nemotron-4-15b at its published
   width cut to 2 of 32 layers (B 1 x 2,048 into a 2,080-row cache, 4
   decode steps: a G 6, D 128 group, which the partials kernel refused
   before) — logits within 2e-2 of their scale (a decode step: or within
   2x the mesh-free run's distance from an f32 run of the same draws: the
   fused kernel rounds P to bf16 on the tensor cores, the partials kernel
   keeps f32; the f32 run on the plain engines), every partials launch on
   its tc form, greedy tokens equal outside near ties, bitwise printed; one ``build_train_step`` of qwen3-1.7b at full
   width cut to 4 of 28 layers (time), 2 x 4,096 tokens, against the
   one-device step (loss within rtol 1e-5, parameters within 2 lr, bitwise
   printed); and, in a CPU-only child started after the build beside the
   card phases, the suite's 2- and 4-rank gloo checks on the torch the
   script runs under (``tests/_torch_mesh_worker.gloo_checks``); one ``[mesh] {...}``
   line with the ms per prefill and decode step beside the mesh-free
   path's (host clock, synchronised), peak memory, and the card's name and
   power limit;
9. the session mesh, in a child process: a one-rank NCCL group, the (1, 1)
   ("data", "model") mesh; phase 4's world placed with
   ``shard_session_state`` serves ``MAIN_TRACE`` through
   ``serve_session_trace`` (the per-rank program, ``core.shard_program``:
   the scoring kernels on the rank's rows, the collectives over the object
   axis) and the grown state runs 8 table-mode epochs, beside the
   mesh-free run in the same child: 24 best-mode and 8 table-mode
   launches, no plain call, ``cost_hex`` / ``bills_hex`` /
   ``answer_digest`` equal after the trace and after the table epochs;
   the pipeline's staging of the trace on the mesh under
   ``set_sync_debug_mode("error")``, its digests equal; ``kill:w1@chunk:4``
   on 2 plan shards through ``Supervisor(mesh=)`` with the digests and
   summary of its mesh-free twin; epochs/s of both, collectives per epoch
   and peak memory beside the card's name and power limit (one
   ``[session-mesh] {...}`` line); the gloo child of phase 8 also runs the
   suite's 2- and 4-rank session-mesh checks
   (``tests/_torch_session_mesh_worker.gloo_checks``);
9b. the reference's serve cells on one card (``launch/cells.py``
   ``SERVE_CELLS``: qwen3-1.7b and mamba2-370m at ``prefill_32k`` and
   ``decode_32k``; hymba-1.5b, h2o-danube-1.8b, gemma2-9b and mamba2-370m
   at ``long_500k``), each at the batch and depth ``one_card_cell``
   reckons for one 80 GB card: first ``rope_frequencies`` / ``apply_rope``
   on the card against the CPU at positions 0 to 524,287, and each kernel
   at the shape a cell gives it against its plain version — the fused
   decode kernel and the split route (the partials' tc form + the combine;
   ``ops.decode_route`` takes it from ``SPLIT_FROM`` keys a fused block) at
   qwen3 B 16 x 32,768, hymba and gemma2's global layer at 524,288 keys,
   and gemma2's and danube's windows at position 524,287 (``CELL_DA``: both
   routes timed, the oracle, the twins, SDPA or ``flex_attention``), the tc
   flash kernel at the qwen3 prefill_32k layer (its twin one query block at
   a time), each with q drawn x 12 or x 16 so that a few keys carry each
   output, and rows planted among the last keys that carry a share of it
   (``_plant_last_rows``): the same kernel without the last 256 keys must
   miss the tolerance (the planted control), and on gemma2's two 2^30-element
   slices this is the index audit; then the tc SSD kernel at the mamba2
   prefill_32k layer (128 chunks; its twin two batch rows at a time) and
   the inter-chunk kernel on its outputs from a given h0 (the same); then
   each cell at full width (random bf16
   weights) through ``build_prefill_step`` / ``build_decode_step`` without
   a mesh (a decode from a ``fill_cache``d cache at ``seq_len - 1``: every
   step writes the last free row and attends over all ``seq_len`` keys):
   the launches by route (every SSD layer of a prefill an intra- and an
   inter-chunk launch), ms a prefill or step (median), tokens/s and peak
   memory, then the gate: at the cell's length and one pattern period (two
   layers where the period is one), the kernel route's logits within 2e-2
   (qwen3, mamba2) or 4e-2 (the zoo) of the plain engines' on the same
   weights and cache;
10. one JSON line of per-kernel numbers, one entry per kernel: the flash
   kernel's four routes as ``flash_attention`` (simt: on no main path, so
   its launches are 0; its numbers the cascade shape's, timed beside the
   short kernel), ``flash_attention_tc``, ``flash_attention_short`` and
   ``flash_attention_split`` (its numbers seamless's cross-attention
   decode's, with the short kernel's ``short_ms`` on the same inputs) (the
   first also carries the tc kernel's prefill-shape ``prefill_ms``,
   ``prefill_bound_ms``, ``prefill_library_ms`` and the main paths'
   ``routes``), ``decode_attention_fused``, ``decode_attention_partials_tc``
   (the partials' tc form: its launches phase 8's mesh decodes, its
   ``shapes`` every zoo group beside the simt form's ``simt_ms``) and
   ``decode_attention_partials`` (the simt form, on no main path: 0
   launches; its numbers the qwen3 row's on the tc form's inputs),
   ``ssd_intra_chunk_tc`` and
   ``ssd_intra_chunk`` (the simt and packed kernels of ``ssd_scan.cu``, its
   numbers the packed kernel's at the cascade shape, with the simt
   kernel's ``prefill_simt_ms`` and the ``routes``), ``ssd_inter_chunk``
   (its numbers the mamba2 prefill's, its launches every SSD layer of
   phases 7-9b's prefills; a cascade block of 8 tokens, one chunk with no
   state entering it, launches none), ``ssm_mixer_front`` and
   ``ssm_mixer_gated_norm`` (their numbers phase 7's mamba2 prefill's, the
   other shapes in ``shapes``, with the values apart from the twin; their
   launches every mamba2 and hymba layer of phases 5-9b, prefill and decode
   step); the scoring kernels
   carry their launches by table route (``routes``: "smem", "global") and
   the global route's phase 2 numbers (``global_route``, best mode's F 10
   and F 11 cases under its ``past_f8`` as ``F10`` and ``F11``, each naming
   its ``kernel``, each best-mode case with its ``divisions``); an
   entry timed at the
   zoo's shapes carries them in ``shapes`` (each with its ms, plain ms,
   bound and library ms; phase 9b's cells' shapes too, with ``serves``
   naming the cell and, for the decode kernels, both routes' ms), and one
   whose softcap was checked where it binds
   its rows in ``softcap``; every other kernel must have launched on a main
   path; the ``nvidia-smi`` line, and the final ``{"ok": true, ...}`` line.

It imports nothing of JAX or of the reference package ``repro``.
"""

from __future__ import annotations

import atexit
import functools
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

T_START = time.perf_counter()  # the script's own start, for its time limit
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
F32_OPS_PER_S = 67e12  # H100 SXM f32 rate outside the tensor cores
BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core rate
C_FULL, P, F, Q = 1 << 20, 4, 4, 8
MAIN_TRACE = "admit:2;admit:3;admit:2;run:8;ingest:524288;admit:4;run:8;retire:0;run:8"
SMOKE_TRACE = [("admit", (0, 1)), ("admit", (1, 2, 3)), ("run", 4), ("ingest", 2048),
               ("admit", (0, 2)), ("run", 4), ("retire", 0), ("run", 4)]
# The planner picks no backbone lane before the cheap levels of its
# candidates are spent, which takes dozens of epochs at 2,048 objects (the
# epoch is printed), so the last run is lengthened from 16 to 88 epochs (96
# in all): enough epochs after the first backbone lane for >= 4 trunk
# epochs, and before the trace has spent everything (an epoch that charges
# nothing fails the run).
CASCADE_TRACE = "admit:2;admit:3;admit:2;run:8;retire:0;admit:2;run:88"
CASCADE_SMOKE_TRACE = [("admit", (0, 1)), ("admit", (1, 2)), ("run", 6), ("admit", (0, 2)),
                       ("run", 6), ("retire", 0), ("run", 8)]
N_OP, P_OP, F_OP = 1 << 20, 2, 4  # the operator's main path: the quickstart at 1M objects
# the scoring kernels' "global" table route (tables outgrowing a block's
# shared memory at 10 bins): best mode at the session's width with eight
# functions (327,680 B), table mode at P 16 (C x P: the session's 4M lanes),
# the single-query kernel at P 11, and best mode past eight functions on each
# side of its choice of kernel (F 10: the lane kernel unrolled to 10; F 11:
# the wide kernel).  kernel, C, P, F, Q
GLOBAL_CASES = (("enrich_score_best", 1 << 20, 4, 8, 8), ("enrich_score_table", 1 << 18, 16, 8, 8),
                ("enrich_score_single", 1 << 20, 11, 8, 1), ("enrich_score_best", 1 << 20, 4, 10, 8),
                ("enrich_score_best", 1 << 20, 4, 11, 8))
# both routes on the same inputs (uncounted): the main paths' shapes, beside
# GLOBAL_CASES the largest P whose table still fits shared memory at F 8,
# and one table on each side of each mode's crossover (``kernel.GLOBAL_FROM``).
# kernel, C, P, F, Q
ROUTE_PAIR_CASES = (("enrich_score_best", 1 << 20, 4, 4, 8),
                    ("enrich_score_best", 1 << 21, 2, 8, 8),
                    ("enrich_score_best", 1 << 21, 2, 6, 8),  # 47,200 B: smem
                    ("enrich_score_best", 1 << 22, 1, 7, 8),  # 52,280 B: global
                    ("enrich_score_table", 1 << 20, 4, 4, 8),
                    ("enrich_score_table", 1 << 18, 10, 8, 8),
                    ("enrich_score_table", 1 << 20, 4, 6, 8),  # 36,960 B: smem
                    ("enrich_score_table", 838_860, 5, 6, 8),  # 42,104 B: global
                    ("enrich_score_single", 1 << 20, 2, 4, 1),
                    ("enrich_score_single", 1 << 20, 9, 8, 1),
                    ("enrich_score_single", 1 << 20, 4, 5, 1),  # 26,704 B: smem
                    ("enrich_score_single", 1 << 20, 3, 6, 1))  # 31,816 B: global
# eight tagging functions of rising quality and cost: the 8-function session
SESSION8_AUCS = (0.60, 0.70, 0.78, 0.84, 0.88, 0.91, 0.93, 0.97)
SESSION8_COSTS = (0.01, 0.02, 0.035, 0.05, 0.08, 0.12, 0.2, 0.5)
SESSION8_TRACE = "admit:2;admit:3;admit:2;run:4"
SESSION8_EPOCHS = 4
# ten: a richer bank per tag, past the smem route's F 8
SESSION10_AUCS = (0.60, 0.66, 0.70, 0.74, 0.78, 0.84, 0.88, 0.91, 0.93, 0.97)
SESSION10_COSTS = (0.01, 0.015, 0.02, 0.035, 0.05, 0.08, 0.12, 0.2, 0.35, 0.5)
OP_EPOCHS = 32
SOURCES = {
    "enrich_score_table": "src/repro_torch/kernels/enrich_score/csrc/enrich_score.cu",
    "enrich_score_best": "src/repro_torch/kernels/enrich_score/csrc/enrich_score.cu",
    "enrich_score_single": "src/repro_torch/kernels/enrich_score/csrc/enrich_score.cu",
    "flash_attention": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
    "flash_attention_tc": "src/repro_torch/kernels/flash_attention/csrc/flash_attention_tc.cu",
    "flash_attention_short":
        "src/repro_torch/kernels/flash_attention/csrc/flash_attention_short.cu",
    "flash_attention_split":
        "src/repro_torch/kernels/flash_attention/csrc/flash_attention_split.cu",
    "decode_attention_partials":
        "src/repro_torch/kernels/decode_attention/csrc/decode_attention.cu",
    "decode_attention_partials_tc":
        "src/repro_torch/kernels/decode_attention/csrc/decode_attention_fused.cu",
    "decode_attention_fused":
        "src/repro_torch/kernels/decode_attention/csrc/decode_attention_fused.cu",
    "ssd_intra_chunk": "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
    "ssd_intra_chunk_tc": "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan_tc.cu",
    "ssd_inter_chunk": "src/repro_torch/kernels/ssd_scan/csrc/ssd_inter_chunk.cu",
    "ssm_mixer_front": "src/repro_torch/kernels/ssm_mixer/csrc/ssm_mixer.cu",
    "ssm_mixer_gated_norm": "src/repro_torch/kernels/ssm_mixer/csrc/ssm_mixer.cu",
}
REPLACES = {
    "enrich_score_table": "src/repro/kernels/enrich_score/kernel.py:318",
    "enrich_score_best": "src/repro/kernels/enrich_score/kernel.py:354",
    "enrich_score_single": "src/repro/kernels/enrich_score/kernel.py:273",
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:122",
    "flash_attention_tc": "src/repro/kernels/flash_attention/kernel.py:122",
    "flash_attention_short": "src/repro/kernels/flash_attention/kernel.py:122",
    "flash_attention_split": "src/repro/kernels/flash_attention/kernel.py:122",
    "decode_attention_partials": "src/repro/kernels/decode_attention/kernel.py:65",
    "decode_attention_partials_tc": "src/repro/kernels/decode_attention/kernel.py:65",
    "decode_attention_fused": "src/repro/kernels/decode_attention/kernel.py:65",
    "ssd_intra_chunk": "src/repro/kernels/ssd_scan/kernel.py:72",
    "ssd_intra_chunk_tc": "src/repro/kernels/ssd_scan/kernel.py:72",
    "ssd_inter_chunk": "src/repro/kernels/ssd_scan/ops.py:18",  # its scan over chunks, :47
    # no Pallas kernel: the reference's jnp mixer, which XLA fuses (the conv
    # + SiLU :73, softplus :191, SiLU(z) :207; the D skip :205, the gated norm :207)
    "ssm_mixer_front": "src/repro/models/ssm.py:73",
    "ssm_mixer_gated_norm": "src/repro/models/ssm.py:205",
}
# the launch counters each JSON entry sums over the main-path runs: the
# flash, SSD and decode wrappers count per route / kernel
COUNTED = {
    "flash_attention": ("flash_attention/simt",),
    "flash_attention_tc": ("flash_attention/tc",),
    "flash_attention_short": ("flash_attention/short",),
    "flash_attention_split": ("flash_attention/split",),
    "ssd_intra_chunk": ("ssd_intra_chunk/simt", "ssd_intra_chunk/packed"),
    "ssd_intra_chunk_tc": ("ssd_intra_chunk/tc",),
    "decode_attention_partials": ("decode_attention_partials/simt",),
    "decode_attention_partials_tc": ("decode_attention_partials/tc",),
}
# listed with their launches but on no main path: the simt flash kernel takes
# f32 and head dims no main path has (the zoo's 80 and 256 run "tc"), and the
# partials kernel's simt form f32 and head dims outside 64 / 80 / 128 / 256.
# The partials kernel is on the model mesh's decode (phase 8: a cache sharded
# on its rows) in its tc form, while the mesh-free decode runs the fused
# kernel.
OFF_PATH = {"flash_attention", "decode_attention_partials"}
# the mamba2-370m prefill (B 2, S 4096, chunk 256) and the cascade backbone's
# 512 lanes x 8 tokens; H 32, P 64, N 128, bf16 x / B / C.  The cascade runs
# without a final state (its last chunk's state is neither computed nor
# written), the prefill with one; both forms are held against the twin.
# The hymba-1.5b prefill (B 1, S 2048, chunk 256) and its cascade trunk
# (512 lanes x 8 tokens): H 50, P 64, N 16 — the tc and packed routes.
# b, s, chunk, final_state, heads, state_dim
SSD_CASES = [(2, 4096, 256, True, 32, 128), (512, 8, 8, False, 32, 128),
             (512, 8, 8, True, 32, 128), (1, 2048, 256, True, 50, 16), (512, 8, 8, False, 50, 16)]
SSD_P = 64
SSD_TOL = 1e-4  # relative to the output's largest magnitude: f32 sums in another order
# the inter-chunk kernel (y = y_intra + cumexp C.h over the chunks' states) on
# the intra-chunk kernel's outputs: the mamba2-370m prefill (B 2, S 4096, h0
# and the final state, as a prefill into a cache runs it), hymba-1.5b's (H
# 50, N 16), a packed cascade block with a state entering it, eight packed
# chunks with none and no final state, and h0 without the final state.
# b, s, chunk, heads, state_dim, h0 given, final_state
INTER_CASES = [(2, 4096, 256, 32, 128, True, True), (1, 2048, 256, 50, 16, True, True),
               (512, 8, 8, 32, 128, True, True), (64, 64, 8, 50, 16, False, False),
               (2, 4096, 256, 32, 128, True, False)]
INTER_OUTPUTS = ("y", "h_final")
# the Mamba-2 mixer's two kernels (csrc/ssm_mixer.cu) at the shapes the main
# paths give them: phase 7's mamba2 prefill (into a cache: a tail in and out),
# hymba's prefill (rows of 6,482 values: 4-byte loads), the cascade trunks'
# 512 lanes x 8 tokens (no cache), a mamba2 decode step at decode_32k's B 128,
# and the prefill_32k layer at B 32 (its twin SSD_BLOCK rows at a time).
# label, arch, b, s, a conv tail (in and out)
MIXER_CASES = [("mamba2 prefill (phase 7)", "mamba2-370m", 2, 4096, True),
               ("hymba prefill", "hymba-1.5b", 1, 2048, True),
               ("mamba2 cascade trunk", "mamba2-370m", 512, 8, False),
               ("hymba cascade trunk", "hymba-1.5b", 512, 8, False),
               ("mamba2 decode step (decode_32k's B 128)", "mamba2-370m", 128, 1, True),
               ("mamba2 prefill_32k layer", "mamba2-370m", 32, 32768, True)]
MIXER_NORM_ULPS = 1  # the norm against its twin: the sum of squares in another order
MIXER_KERNELS = ("ssm_mixer_front", "ssm_mixer_gated_norm")  # one launch each an SSM layer
# qwen3-1.7b decode: B 8, H 16, KV 8, D 128, kv_len 2048 of a 4096 cache;
# b, skv, h, kv, d, kv_len, window, softcap, dtype
DA_CASES = [
    (8, 4096, 16, 8, 128, 2048, None, None, "bfloat16"),
    (8, 4096, 16, 8, 128, 2048, None, None, "float32"),
    (8, 4096, 16, 8, 128, 2048, 512, 50.0, "bfloat16"),
]
# then the model zoo's decode shapes (B 1, the mid step of a zoo prefill + 16
# steps into a cache of prefill + 32 rows), each with the layers it serves:
# bf16 on the tc form (at D 80 / 256 beside the simt form, uncounted), and
# the two D 80 / 256 shapes in f32 on the simt form (its FUSED_VALUES = 64)
ZOO_DA = {
    (1, 4640, 32, 8, 80, 4616, 4097, None, "bfloat16"): "h2o-danube (G 4, D 80)",
    (1, 4640, 32, 8, 80, 4616, 4097, None, "float32"): "h2o-danube (G 4, D 80)",
    (1, 4640, 16, 8, 256, 4616, 4097, 50.0, "bfloat16"): "gemma2 local (G 2, D 256)",
    (1, 4640, 16, 8, 256, 4616, 4097, 50.0, "float32"): "gemma2 local (G 2, D 256)",
    (1, 4640, 16, 8, 256, 4616, None, 50.0, "bfloat16"): "gemma2 global (G 2, D 256)",
    (1, 2080, 25, 5, 64, 2056, None, None, "bfloat16"): "hymba (G 5, D 64)",
    (1, 2080, 48, 8, 128, 2056, None, None, "bfloat16"): "nemotron (G 6, D 128)",
    (1, 3424, 32, 8, 128, 3400, None, None, "bfloat16"): "llava (G 4, D 128)",
    (1, 544, 48, 8, 128, 520, None, None, "bfloat16"): "grok-1 (G 6, D 128)",
    (1, 544, 56, 8, 128, 520, None, None, "bfloat16"): "arctic (G 7, D 128)",
    (1, 544, 16, 16, 64, 520, None, None, "bfloat16"): "seamless self-attention (G 1, D 64)",
}
DA_CASES += ZOO_DA
# the decode kernels' softcap where it binds: q drawn x12 / x16 against caps of
# 30 / 50, so |s / cap| reaches ~2 (unit-normal q barely feels a cap of 30-50);
# the fused kernel in its tc form (bf16 D 64 / 80 / 128 / 256: gemma2's local
# and global shapes) and simt form (f32, D 80 / 128 / 256), and the partials
# kernel where it takes the group; without their cap (uncounted launches) each
# must miss.
# b, skv, h, kv, d, kv_len, window, softcap, dtype, q_scale
DA_BINDING = [
    (8, 4096, 16, 8, 128, 2048, 512, 50.0, "bfloat16", 16.0),
    (8, 4096, 16, 8, 128, 2048, 512, 50.0, "float32", 16.0),
    (1, 1024, 16, 2, 64, 1000, None, 30.0, "bfloat16", 12.0),
    (1, 4640, 32, 8, 80, 4616, 4097, 30.0, "bfloat16", 12.0),
    (1, 4640, 32, 8, 80, 4616, 4097, 30.0, "float32", 12.0),
    (1, 4640, 16, 8, 256, 4616, 4097, 50.0, "bfloat16", 16.0),
    (1, 4640, 16, 8, 256, 4616, 4097, 50.0, "float32", 16.0),
    (1, 4640, 16, 8, 256, 4616, None, 50.0, "bfloat16", 16.0),
]
DA_ROW = DA_CASES[0]  # the table's row: the qwen3-1.7b decode
DA_TOL = 2e-5  # partials (m, l, acc): f32 sums in another order
# the model serve paths at full width: (arch, batch, prompt, decode steps, cache)
SERVE_PATHS = [("qwen3-1.7b", 8, 2048, 32, 4096), ("mamba2-370m", 2, 4096, 32, 4128)]
SERVE_LOGIT_TOL = 1e-3  # reduced f32 models, CPU vs card: matmul sums in another order
# the reduced bf16 models (configs/archs.py bf16_check): prompt, decode steps, batch
BF16_CHECK = {"qwen3-1.7b": (96, 8, 2), "mamba2-370m": (512, 8, 2), "gemma2-9b": (96, 8, 2),
              "h2o-danube-1.8b": (96, 8, 2), "hymba-1.5b": (512, 8, 2),
              "seamless-m4t-large-v2": (96, 8, 2)}
# the MoE smoke models, CPU vs card in f32 (routing must be equal) and bf16
# (routing flips only printed): prompt, decode steps, batch
MOE_CHECK = {"grok-1-314b": (64, 8, 2), "arctic-480b": (64, 8, 2)}
MOE_LOGIT_TOL = 2e-4  # f32: matmul sums in another order, through the same routing
# phase 7b, the model zoo at published widths, at ``launch/profile.py``'s
# MODEL_SHAPES (batch 1) and depth cuts (ONE_CARD_LAYERS), and its decode steps
ZOO_ARCHS = ("nemotron-4-15b", "gemma2-9b", "h2o-danube-1.8b", "hymba-1.5b",
             "llava-next-mistral-7b", "seamless-m4t-large-v2", "grok-1-314b", "arctic-480b")
ZOO_STEPS = 16
# card vs CPU, both bf16: at most this many times the CPU bf16 run's distance
# from an f32 run of the same weights (bf16 rounds each activation to 2^-9
# relative, and the card and the CPU round at other places: two bf16 runs lie
# about sqrt(2) times one run's error apart, and under 2x it)
BF16_LOGIT_FACTOR = 2.0
# b, sq, skv, h, kv, d, causal, window, softcap, dtype, kv_len, q_offset_from_kv_len[,
# q_scale]: q is drawn unit-normal times q_scale (1 when left out)
BACKBONE_FA = (512, 8, 8, 16, 8, 128, False, None, None, "bfloat16", None, True)
LONG_FA = (1, 4096, 4096, 16, 8, 128, True, None, None, "bfloat16", None, False)
# phase 7's qwen3-1.7b prefill: 8 x 2048 queries at the end of 2048 valid rows of a 4096 cache
PREFILL_FA = (8, 2048, 4096, 16, 8, 128, True, None, None, "bfloat16", 2048, True)
FA_CASES = [
    BACKBONE_FA,
    BACKBONE_FA[:9] + ("float32",) + BACKBONE_FA[10:],
    (1, 128, 128, 4, 2, 32, True, None, None, "float32", None, False),  # the reference's cases
    (2, 256, 256, 4, 4, 64, True, None, 50.0, "float32", None, False),
    (1, 128, 128, 8, 2, 32, True, 48, None, "float32", None, False),
    (2, 128, 128, 4, 1, 64, False, None, None, "float32", None, False),
    (1, 256, 256, 4, 2, 32, True, None, None, "bfloat16", None, False),
    (1, 64, 256, 4, 2, 32, True, None, None, "float32", 100, True),  # partial kv_len
    (2, 200, 333, 4, 2, 128, True, 100, 30.0, "bfloat16", 300, True),  # ragged "tc" tiles
    (2, 200, 333, 4, 2, 80, True, 100, 30.0, "bfloat16", 300, True),  # D 80: padded tiles
    (2, 200, 333, 4, 2, 256, True, 100, 30.0, "bfloat16", 300, True),  # D 256: 64-key tiles
    (1, 200, 256, 2, 1, 80, True, None, None, "bfloat16", 100, True),  # rows 0-99: no key
    (1, 200, 256, 2, 1, 256, True, None, None, "bfloat16", 100, True),
    # scores about N(0, 12^2) against a cap of 30: the softcap binds (|s / cap| up to ~2)
    (2, 200, 333, 4, 2, 128, True, 100, 30.0, "bfloat16", 300, True, 12.0),
    (2, 200, 333, 4, 2, 80, True, 100, 30.0, "bfloat16", 300, True, 12.0),
    (2, 200, 333, 4, 2, 256, True, 100, 30.0, "bfloat16", 300, True, 12.0),
    (2, 33, 128, 8, 2, 128, True, 24, 30.0, "bfloat16", 100, True),  # "short": G*Sq = 132
    (4, 8, 64, 4, 2, 64, True, 4, 20.0, "bfloat16", 6, True),  # "short", D 64, dead rows
    (3, 8, 300, 8, 4, 128, True, 100, None, "bfloat16", 250, True),  # "short", G 2, 7 key tiles
    (3, 8, 300, 4, 4, 128, True, 100, None, "bfloat16", 250, True),  # "split": G 1 x Sq 8
    (2, 4, 300, 8, 4, 128, True, 100, None, "bfloat16", 250, True),  # "split": G 2 x Sq 4
    (1, 8, 256, 1, 1, 64, True, None, None, "bfloat16", 4, True),  # "split": rows 0-3 dead
    LONG_FA,
    PREFILL_FA,
]
# the tc pipeline's edges at D 64 and 128 (two products in flight in each
# consumer warpgroup, the warpgroups' turns on named barriers)
for _d in (64, 128):
    FA_CASES += [
        (1, 128, 128, 4, 2, _d, False, None, None, "bfloat16", None, False),  # 1 live key tile
        (1, 128, 256, 4, 2, _d, False, None, None, "bfloat16", None, False),  # 2
        (1, 128, 384, 4, 2, _d, False, None, None, "bfloat16", None, False),  # 3
        (1, 200, 200, 4, 2, _d, True, None, None, "bfloat16", None, False),  # 8 rows in wg 1
        (1, 200, 256, 2, 1, _d, True, None, None, "bfloat16", 100, True),  # rows 0-99: no key
        # rows 0-139 see no key: query tiles with no live key tile beside tiles with four
        (1, 640, 640, 2, 1, _d, True, None, None, "bfloat16", 500, True),
        (1, 64, 256, 4, 2, _d, True, 64, None, "bfloat16", None, True),  # window: one tile
    ]
FA_CASES.append((2, 200, 333, 4, 2, 64, True, 100, 30.0, "bfloat16", 300, True, 12.0))
# the model zoo's attention at full width (phase 7b's shapes: a prefill's
# queries at the end of its live rows of a cache 32 rows longer), each with
# the layers it serves; D 80 and D 256 take the tc kernel, timed beside the
# simt kernel on the same inputs
ZOO_FA = {
    (1, 1024, 1024, 16, 16, 64, False, None, None, "bfloat16", None, True):
        "seamless encoder (non-causal, G 1)",
    (1, 512, 1024, 16, 16, 64, False, None, None, "bfloat16", None, True):
        "seamless cross-attention prefill (512 queries over 1,024 frames)",
    (1, 1, 1024, 16, 16, 64, False, None, None, "bfloat16", None, True):
        "seamless cross-attention decode (1 query)",
    (1, 512, 544, 16, 16, 64, True, None, None, "bfloat16", 512, True):
        "seamless decoder self-attention (G 1)",
    (512, 8, 8, 25, 5, 64, False, None, None, "bfloat16", None, True):
        "hymba cascade trunk (512 lanes x 8 tokens, G 5)",
    (1, 2048, 2080, 25, 5, 64, True, None, None, "bfloat16", 2048, True):
        "hymba prefill (G 5)",
    (1, 2048, 2080, 48, 8, 128, True, None, None, "bfloat16", 2048, True):
        "nemotron prefill (G 6)",
    (1, 3392, 3424, 32, 8, 128, True, None, None, "bfloat16", 3392, True):
        "llava prefill (2,880 image embeds + 512 tokens, G 4)",
    (1, 512, 544, 48, 8, 128, True, None, None, "bfloat16", 512, True): "grok-1 prefill (G 6)",
    (1, 512, 544, 56, 8, 128, True, None, None, "bfloat16", 512, True): "arctic prefill (G 7)",
    (1, 4608, 4640, 32, 8, 80, True, 4096, None, "bfloat16", 4608, True):
        "h2o-danube prefill (D 80, past its 4,096-key window)",
    (1, 4608, 4640, 16, 8, 256, True, 4096, 50.0, "bfloat16", 4608, True):
        "gemma2 local layers (D 256, window 4,096, softcap 50)",
    (1, 4608, 4640, 16, 8, 256, True, None, 50.0, "bfloat16", 4608, True):
        "gemma2 global layers (D 256, softcap 50)",
}
FA_CASES += ZOO_FA
# the short, split and simt kernels' softcap where it binds (q x12 / x16; each
# checked against the same kernel without its cap, uncounted)
FA_CASES += [
    (2, 33, 128, 8, 2, 128, True, 24, 30.0, "bfloat16", 100, True, 12.0),  # short, D 128
    (2, 33, 128, 8, 2, 64, True, 24, 30.0, "bfloat16", 100, True, 12.0),  # short, D 64
    (512, 8, 8, 16, 8, 128, False, None, 50.0, "bfloat16", None, True, 16.0),  # short, cascade
    (2, 4, 300, 8, 4, 128, True, 100, 30.0, "bfloat16", 250, True, 12.0),  # split, D 128
    (1, 1, 1024, 16, 16, 64, False, None, 30.0, "bfloat16", None, True, 12.0),  # split, D 64
    (2, 256, 256, 4, 4, 64, True, None, 50.0, "float32", None, False, 16.0),  # simt, f32
    (2, 200, 333, 4, 2, 48, True, 100, 30.0, "bfloat16", 300, True, 12.0),  # simt, bf16 D 48
    (1, 2048, 2048, 16, 8, 256, True, None, 50.0, "float32", None, False, 16.0),  # simt, D 256
]
# gemma2's global layer with scores about N(0, 16^2) against its cap of 50
GEMMA2_GLOBAL_CAPPED = (1, 4608, 4640, 16, 8, 256, True, None, 50.0, "bfloat16", 4608, True, 16.0)
FA_CASES.append(GEMMA2_GLOBAL_CAPPED)
FA_TIMED = (BACKBONE_FA, FA_CASES[1], LONG_FA, PREFILL_FA, *ZOO_FA)
FA_TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _binding_tol(tol: float, dtype: str, q_scale: float) -> float:
    """A case's tolerance at q drawn x ``q_scale``: f32 rounds each score to
    ~2^-24 of its size, so the scores' absolute errors, and the outputs'
    with them, are ``q_scale`` times the unit-normal case's; in bf16 the
    output's own rounding (2^-8) dominates and the tolerance stays."""
    return tol * q_scale if dtype == "float32" else tol
# the train phase: the smoke configs in f32, CPU vs card (seq, batch,
# microbatches, AdamW steps), each gradient leaf within TRAIN_GRAD_TOL of the
# leaf's largest magnitude (f32 sums in another order), the parameters after
# the steps within 2 * lr a step (a near-zero gradient whose sign differs moves
# AdamW's early update by ~2 * lr) and all but 0.1% within 0.01 * lr
TRAIN_CHECK = ("qwen3-1.7b", "mamba2-370m", "grok-1-314b")
TRAIN_CHECK_SHAPE = (32, 4, 2, 2)
TRAIN_GRAD_TOL = 1e-4
# then qwen3-1.7b at full width: train_4k's 4,096 tokens, its batch of 256 cut to
# 8 (2 microbatches of 4), 4 AdamW steps; the resume check runs the same at
# full width with the depth cut to 4 of 28 layers (a 6.1 GB checkpoint, not
# 20.6 GB: the full one took ~120 s to write and read), cut at step 2
TRAIN_FULL = ("qwen3-1.7b", 4096, 8, 2, 4)
TRAIN_RESUME_LAYERS = 4
TRAIN_RESUME_AT = 2
TRAIN_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_train"
# the cascade bank with the reduced bf16 qwen3 trunk (bf16_check: head_dim
# 128, 2 query heads over 1 KV head, so 16 query rows a (lane, kv head) at 8
# tokens): objects, predicates, merged plans of this many lanes
CASCADE_BF16 = (128, 3, 96, 3)


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


SLEEP_CYCLES = 10_000_000  # ~5.7 ms of device time at 1.755 GHz


ALONE_MS = 1.0  # _time_ms: a call at least this long is timed one call a run


def _time_ms(fn, reps: int = 25, warmup: int = 3, inner: int = 10) -> float:
    """Median over ``reps`` CUDA-event timings of a run of ``inner`` calls of
    ``fn``, per call, after warm-up.  Each run is enqueued behind a device
    sleep (``torch.cuda._sleep``) that outlasts the host's launches, so the
    calls run back to back on the card and a kernel shorter than its
    wrapper's host overhead (tens of microseconds a call from Python) is
    timed as the card runs it.  A call that synchronises (a plain twin that
    reads a device scalar) is timed with its host gaps, as it runs.  A call
    that takes ``ALONE_MS`` or more runs alone (``inner`` 1): its launch
    overhead is under 1% of it, and ten calls a run would add seconds to the
    script for no gain in what is measured."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    if start.elapsed_time(end) >= ALONE_MS:
        inner = 1
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def _host_ms(fn, calls: int = 200) -> float:
    """Per call, host clock around ``calls`` calls and one synchronise: what
    a caller that issues one call after another pays, launch overhead and
    all."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e3


def _bound(mode: str, prob_bytes: int, c: int, p: int, f: int, q: int, table_bytes: int):
    """(bound_ms, bound_by): each input read once, each output written once,
    against the count of f32 operations this work needs."""
    lanes = c * p
    read = lanes * (2 * prob_bytes + 4) + q * c * prob_bytes + table_bytes
    written = 4 * q * lanes * 4  # benefit, next_fn, est_joint, cost
    # per lane: bin, lerp, clip and cost (~12 ops, per function in best mode);
    # per lane and tenant: est_joint and benefit (~6 ops, per function in best)
    per_f = f if mode == "best" else 1
    ops = lanes * 12 * per_f + q * lanes * 6 * per_f
    t_bytes = (read + written) / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _es_counts(ops) -> dict:
    """The scoring kernels' launches by kernel and by "kernel/table route"."""
    return {**ops.LAUNCHES, **{f"{k}/{r}": n for (k, r), n in ops.TABLE_ROUTES.items()}}


def _es_expect(table: int = 0, best: int = 0, single: int = 0) -> dict:
    """``_es_counts`` of a run whose every scoring launch took the smem route."""
    want = {"enrich_score_table": table, "enrich_score_best": best, "enrich_score_single": single}
    return {**want, **{f"{k}/smem": n for k, n in want.items()},
            **{f"{k}/global": 0 for k in want}}


# ------------------------------------------------------------------ phases --


def phase_build():
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels.decode_attention import kernel as da_kernel
    from repro_torch.kernels.enrich_score import kernel as es_kernel
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.kernels.ssm_mixer import kernel as mixer_kernel

    t0 = time.perf_counter()
    builds = (es_kernel.build, fa_kernel.build, fa_kernel.build_tc, fa_kernel.build_short,
              fa_kernel.build_split, da_kernel.build, da_kernel.build_fused, ssd_kernel.build,
              ssd_kernel.build_tc, ssd_kernel.build_inter, mixer_kernel.build,
              functools.partial(fa_kernel.build_tc, tanhf=True))  # phase 2's softcap check
    with ThreadPoolExecutor(len(builds)) as pool:  # one nvcc per source, all at once
        built = [f.result() for f in [pool.submit(b) for b in builds]]
    for load in (es_kernel.library, fa_kernel.library, fa_kernel.library_tc,
                 fa_kernel.library_short, fa_kernel.library_split, da_kernel.library,
                 da_kernel.library_fused,
                 ssd_kernel.library, ssd_kernel.library_tc, ssd_kernel.library_inter,
                 mixer_kernel.library):
        load()
    for path, log, nvcc_s in built:
        print(f"[build] {path.name}: nvcc {nvcc_s:.2f} s", flush=True)
        name = ""
        for line in log.splitlines():  # ptxas -v: one summary per kernel instantiation
            if "Compiling entry function" in line:
                name = line.split("'")[1] if "'" in line else line.strip()
            elif ("spill stores" in line or "Used" in line or "warning" in line
                  or "wgmma" in line or "(C75" in line or "error" in line):
                print(f"[build] ptxas {name}: {line.split(' : ')[-1].strip()}", flush=True)
    print(f"[build] all kernels ready in {time.perf_counter() - t0:.2f} s", flush=True)


def _small_world(aucs=None, costs=None, learn_on="cpu"):
    """A learned table + combine params + corpus outputs, made on the CPU
    (the session's four functions unless ``aucs`` / ``costs`` name others);
    the table learned on ``learn_on`` (2^F states: ten functions take ~30 s
    on a few CPU cores) and returned on the CPU."""
    import torch

    from repro_torch.core.combine import fit_combine_weights
    from repro_torch.core.decision_table import learn_decision_table
    from repro_torch.data.synthetic import make_corpus, split_corpus
    from repro_torch.launch.serve import SESSION_AUCS, SESSION_COSTS

    gen = torch.Generator().manual_seed(1)
    corpus = make_corpus(gen, 512 + 4096, list(range(P)), [1] * P, selectivity=[0.3] * P,
                         aucs=aucs or SESSION_AUCS, costs=costs or SESSION_COSTS)
    train, evalc = split_corpus(corpus, 512)
    combine = fit_combine_weights(train.func_probs, train.truth_pred.float(), steps=150)
    table = learn_decision_table(train.func_probs.to(learn_on), combine.to(learn_on),
                                 num_bins=10).to("cpu")
    return table, combine, evalc.costs, evalc.func_probs


def _kernel_inputs(dev, dtype, edge: bool, seed: int, c=C_FULL, p=P, f=F, q=Q):
    import torch

    from repro_torch.core.entropy import binary_entropy

    g = torch.Generator(device=dev).manual_seed(seed)
    pp = torch.rand((c, p), generator=g, device=dev) * 0.96 + 0.02
    sid = torch.randint(0, 2**f, (c, p), generator=g, device=dev, dtype=torch.int32)
    if edge:  # h ~ 0 (saturated), h ~ 1 (coin flips), exhausted rows
        third = c // 3
        pp[:third] = torch.rand((third, p), generator=g, device=dev) * 1e-4 + 1e-6
        pp[third:2 * third] = 0.5 + (torch.rand((third, p), generator=g, device=dev) - 0.5) * 2e-5
        sid[2 * third:] = 2**f - 1
    joint = torch.rand((q, c), generator=g, device=dev)
    return pp.to(dtype), binary_entropy(pp).to(dtype), sid, joint.to(dtype)


def _hold_bitwise(label: str, got, want, result: dict) -> None:
    """All four outputs bitwise equal to the plain version's; the largest
    finite difference (0) into ``result["max_abs_err"]``."""
    import torch

    for field, a, b in zip(("benefit", "next_fn", "est_joint", "cost"), got, want):
        if not torch.equal(a, b):
            diff = (a.double() - b.double()).abs().nan_to_num(0.0).max().item()
            raise AssertionError(f"{label}: {field} differs from the plain version "
                                 f"(max abs diff {diff})")
        fin = torch.isfinite(a.double()) & torch.isfinite(b.double())
        result["max_abs_err"] = max(result["max_abs_err"],
                                    (a.double() - b.double()).abs()[fin].max().item())


def phase_kernels(table, costs) -> dict:
    import torch

    from repro_torch.kernels.enrich_score import ops, ref

    dev = torch.device("cuda")
    table, costs = table.to(dev), costs.to(dev)
    lut = ops._lut(4096, dev)
    table_bytes = {
        "enrich_score_table": 4 * (2 * table.delta_h.numel() + costs.numel() + lut.numel()),
        "enrich_score_best": 4 * (table.delta_h_all.numel() + costs.numel() + lut.numel()),
    }
    results = {name: {"max_abs_err": 0.0} for name in ("enrich_score_table", "enrich_score_best")}
    for dtype in (torch.float32, torch.bfloat16):
        for edge in (False, True):
            pp, unc, sid, joint = _kernel_inputs(dev, dtype, edge, seed=7 + edge)
            for mode, name in (("table", "enrich_score_table"), ("best", "enrich_score_best")):
                def kernel_call():
                    return ops.fused_benefits_batched(pp, unc, sid, joint, table, costs, mode)

                def plain_call():
                    if mode == "best":
                        return ref.enrich_score_best_ref(
                            pp, unc, sid, joint, table.delta_h_all, costs, lut)
                    return ref.enrich_score_table_ref(
                        pp, unc, sid, joint, table.delta_h, table.next_fn, costs, lut)

                out, want = kernel_call(), plain_call()
                torch.cuda.synchronize()
                _hold_bitwise(f"{name} {dtype} edge={edge}", out, want, results[name])
                if edge:
                    assert (out.next_fn[:, 2 * (C_FULL // 3):] == -1).all()
                    continue
                ms, plain_ms = _time_ms(kernel_call), _time_ms(plain_call)
                bound_ms, bound_by = _bound(mode, pp.element_size(), C_FULL, P, F, Q,
                                            table_bytes[name])
                print(f"[kernels] {name} {str(dtype)[6:]} C={C_FULL} P={P} F={F} Q={Q}: "
                      f"bitwise equal to plain (benefit, next_fn, est_joint, cost); "
                      f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
                      f"({bound_by}), {bound_ms / ms:.1%} of bound", flush=True)
                if dtype == torch.bfloat16:  # the main path's storage dtype
                    results[name].update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                         bound_by=bound_by)
    return results


def _single_bound(table_bytes: int, n: int = N_OP, p: int = P_OP) -> tuple:
    """(bound_ms, bound_by) of one single-query launch: pred_prob, unc and
    state_id [N, P] (4 B each), joint [N] (4 B) and cand [N] (1 B) read once,
    the four [N, P] outputs that fused_benefits returns (4 B each, the
    unfloored cost among them) written once; ~18 f32 operations a lane."""
    lanes = n * p
    nbytes = lanes * 12 + n * 5 + table_bytes + lanes * 16
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = lanes * 18 / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_single_kernel(table) -> dict:
    """The single-query kernel against its plain twin at the operator's shape."""
    import torch

    from repro_torch.core.entropy import binary_entropy
    from repro_torch.core.query import Predicate, conjunction
    from repro_torch.core.state import EnrichmentState
    from repro_torch.kernels.enrich_score import kernel, ops, ref

    dev = torch.device("cuda")
    table = table.to(dev)
    costs = torch.tensor([[0.023, 0.114, 0.42, 0.949]] * P_OP, device=dev)
    lut = ops._lut(4096, dev)
    query = conjunction(Predicate(0, 1), Predicate(1, 2))
    result = {"max_abs_err": 0.0}
    for edge in (False, True):
        g = torch.Generator(device=dev).manual_seed(17 + edge)
        pp = torch.rand((N_OP, P_OP), generator=g, device=dev) * 0.96 + 0.02
        sid = torch.randint(0, 2**F_OP, (N_OP, P_OP), generator=g, device=dev, dtype=torch.int32)
        if edge:  # h ~ 0 (saturated), h ~ 1 (coin flips), exhausted rows
            third = N_OP // 3
            pp[:third] = torch.rand((third, P_OP), generator=g, device=dev) * 1e-4 + 1e-6
            pp[third:2 * third] = 0.5 + (torch.rand((third, P_OP), generator=g,
                                                    device=dev) - 0.5) * 2e-5
            sid[2 * third:] = 2**F_OP - 1
        bits = (sid[..., None] >> torch.arange(F_OP, device=dev)) & 1
        st = EnrichmentState(
            func_probs=torch.full((N_OP, P_OP, F_OP), 0.5, device=dev), exec_mask=bits.bool(),
            pred_prob=pp, uncertainty=binary_entropy(pp),
            joint_prob=torch.rand((N_OP,), generator=g, device=dev),
            in_answer=torch.rand((N_OP,), generator=g, device=dev) < 0.3,  # ~30% no candidates
            cost_spent=torch.zeros((), device=dev))
        cand = (~st.in_answer).contiguous()
        args = (st.pred_prob, st.uncertainty, sid, st.joint_prob, cand, table.delta_h,
                table.next_fn, costs, lut)
        raw = tuple(torch.empty((N_OP, P_OP), dtype=dt, device=dev)
                    for dt in (torch.float32, torch.int32, torch.float32, torch.float32))

        def kernel_call():
            kernel.launch_single(*args, raw, "smem")

        def plain_call():
            return ref.enrich_score_single_ref(*args)

        wrapped = ops.fused_benefits(st, query, table, costs)
        kernel_call()
        want = plain_call()
        torch.cuda.synchronize()
        _hold_bitwise(f"enrich_score_single edge={edge}", raw, want, result)
        _hold_bitwise(f"fused_benefits edge={edge}", wrapped, want, result)
        assert torch.isneginf(raw[0][st.in_answer]).all()
        if edge:
            assert (raw[1][2 * (N_OP // 3):] == -1).all()
            continue
        ms, plain_ms = _time_ms(kernel_call), _time_ms(plain_call)
        table_bytes = 4 * (2 * table.delta_h.numel() + costs.numel() + lut.numel())
        bound_ms, bound_by = _single_bound(table_bytes)
        print(f"[kernels] enrich_score_single f32 N={N_OP} P={P_OP} F={F_OP}, "
              f"{int(st.in_answer.sum())} objects no candidates: bitwise equal to plain "
              f"(benefit, next_fn, est_joint, cost); kernel {ms:.4f} ms, plain {plain_ms:.4f} "
              f"ms, bound {bound_ms:.4f} ms ({bound_by}), {bound_ms / ms:.1%} of bound",
              flush=True)
        result.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
    return result


def phase_global_tables(table8, costs8) -> dict:
    """Each scoring kernel's "global" table route (tables outgrowing a
    block's shared memory) against its plain twin at ``GLOBAL_CASES``: all
    four outputs bitwise on plain and edge-bin rows, each wrapper launch
    counted on the route; timed beside the bound (the table read once) and
    the plain twin.  Best mode at F 8 scores with ``table8``, the
    8-function session world's learned table; best mode at F 10 and 11,
    table mode and the single-query kernel with the analytic fallback
    table.  -> {kernel: {...}}, a best-mode case past F 8 under the
    kernel's ``"past_f8"`` as ``"F<f>"``, with the CUDA kernel that ran it"""
    import numpy as np
    import torch

    from repro_torch.core.decision_table import fallback_decision_table
    from repro_torch.core.query import Predicate, conjunction
    from repro_torch.core.state import EnrichmentState
    from repro_torch.kernels.enrich_score import kernel, ops, ref

    dev = torch.device("cuda")
    lut = ops._lut(4096, dev)
    results = {}
    for name, c, p, f, q in GLOBAL_CASES:
        mode = name.rsplit("_", 1)[1]
        past8 = mode == "best" and f > kernel.SMEM_MAX_FUNCTIONS
        if mode == "best" and not past8:
            table, costs = table8.to(dev), costs8.to(dev)
        else:
            table = fallback_decision_table(p, f, torch.linspace(0.6, 0.9, f)).to(dev)
            costs = torch.tensor(np.tile(np.linspace(0.05, 0.9, f), (p, 1)), dtype=torch.float32,
                                 device=dev)
        table_bytes = 4 * ((table.delta_h_all.numel() if mode == "best" else
                            2 * table.delta_h.numel()) + costs.numel() + lut.numel())
        assert table.delta_h.shape == (p, 2**f, 10), table.delta_h.shape
        assert kernel.table_route(mode, p, 2**f, 10, f, 4096) == "global"
        result = {"max_abs_err": 0.0, "c": c, "p": p, "f": f, "q": q, "bins": 10,
                  "table_bytes": table_bytes}
        if past8:
            result["kernel"] = ("enrich_score_best_lane_kernel"
                                if f <= kernel.LANE_MAX_FUNCTIONS else
                                "enrich_score_best_wide_kernel")
        dtypes = (torch.float32,) if mode == "single" else (torch.bfloat16, torch.float32)
        for dtype in dtypes:
            for edge in (False, True):
                pp, unc, sid, joint = _kernel_inputs(dev, dtype, edge, 31 + edge, c, p, f, q)
                label = f"{name} global F{f} {str(dtype)[6:]} edge={edge}"
                before = ops.TABLE_ROUTES[(name, "global")]
                if mode == "single":
                    g = torch.Generator(device=dev).manual_seed(37 + edge)
                    bits = (sid[..., None] >> torch.arange(f, device=dev)) & 1
                    st = EnrichmentState(
                        func_probs=torch.full((c, p, f), 0.5, device=dev),
                        exec_mask=bits.bool(), pred_prob=pp, uncertainty=unc,
                        joint_prob=joint[0].contiguous(),
                        in_answer=torch.rand((c,), generator=g, device=dev) < 0.3,
                        cost_spent=torch.zeros((), device=dev))
                    args = (pp, unc, sid, st.joint_prob, (~st.in_answer).contiguous(),
                            table.delta_h, table.next_fn, costs, lut)
                    raw = tuple(torch.empty((c, p), dtype=dt, device=dev) for dt in
                                (torch.float32, torch.int32, torch.float32, torch.float32))
                    wrapped = ops.fused_benefits(st, conjunction(*[Predicate(i, 1)
                                                                   for i in range(p)]),
                                                 table, costs)

                    def kernel_call():
                        kernel.launch_single(*args, raw, "global")

                    def plain_call():
                        return ref.enrich_score_single_ref(*args)

                    kernel_call()
                    got, fn_rows = raw, raw[1][2 * (c // 3):]
                else:
                    def kernel_call():
                        return ops.fused_benefits_batched(pp, unc, sid, joint, table, costs,
                                                          mode)

                    def plain_call():
                        if mode == "best":
                            return ref.enrich_score_best_ref(pp, unc, sid, joint,
                                                             table.delta_h_all, costs, lut)
                        return ref.enrich_score_table_ref(pp, unc, sid, joint, table.delta_h,
                                                          table.next_fn, costs, lut)

                    got = kernel_call()
                    fn_rows = got[1][:, 2 * (c // 3):]
                want = plain_call()
                torch.cuda.synchronize()
                assert ops.TABLE_ROUTES[(name, "global")] == before + 1, ops.TABLE_ROUTES
                _hold_bitwise(label, got, want, result)
                if mode == "single":  # the raw launch above, and the counted wrapper
                    _hold_bitwise(f"{label} (wrapper)", wrapped, want, result)
                if edge:
                    assert (fn_rows == -1).all(), f"{label}: exhausted rows chose a function"
                    continue
                ms, plain_ms = _time_ms(kernel_call), _time_ms(plain_call, reps=5, inner=2)
                bound_ms, bound_by = (_single_bound(table_bytes, c, p) if mode == "single" else
                                      _bound(mode, pp.element_size(), c, p, f, q, table_bytes))
                result[str(dtype)[6:]] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                              bound_by=bound_by)
                if mode == "best":
                    result[str(dtype)[6:]]["divisions"] = _screen_divisions(
                        pp, unc, sid, joint, table.delta_h_all, costs, lut, want)
                which = f" ({result['kernel']})" if past8 else ""
                print(f"[kernels] {name}{which} global route {str(dtype)[6:]} "
                      f"C={c} P={p} F={f} Q={q}, 10 bins (table {table_bytes} B): bitwise equal to plain "
                      f"(benefit, next_fn, est_joint, cost); kernel {ms:.4f} ms, plain "
                      f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
                      f"{bound_ms / ms:.1%} of bound", flush=True)
        if past8:
            results[name].setdefault("past_f8", {})[f"F{f}"] = result
        else:
            results[name] = result
    for name, c, p, f, q in ROUTE_PAIR_CASES:
        results[name].setdefault("same_inputs", []).append(
            dict(c=c, p=p, f=f, q=q, **_route_pair(name, c, p, f, q, lut)))
    return results


def _screen_divisions(pp, unc, sid, joint, delta_all, costs, lut, want) -> dict:
    """The benefit divisions best mode's lane kernels do on these inputs
    (``ref.best_screen``, whose outputs must be ``want``'s) beside the
    functions that remain (what a fold without the screen divides), per
    (tenant, lane)."""
    import torch

    from repro_torch.kernels.enrich_score import ref

    out, divisions = ref.best_screen(pp, unc, sid, joint, delta_all, costs, lut)
    for a, b in zip(out, want):
        assert torch.equal(a, b), "the screen's PyTorch twin differs from the plain version"
    rows = delta_all[torch.arange(pp.shape[1], device=pp.device)[None, :], sid.long(),
                     ref._bins(unc.float(), delta_all.shape[2])]
    lane_tenants = joint.shape[0] * pp.numel()
    return {"per_lane_tenant": divisions / lane_tenants,
            "remaining_per_lane_tenant": int(torch.isfinite(rows).sum()) * joint.shape[0]
            / lane_tenants}


def _route_pair(name, c, p, f, q, lut) -> dict:
    """One kernel's smem and global routes on the same inputs (f32 rows, the
    fallback table, uncounted launches) at a shape whose table still fits
    shared memory: what reading the table from device memory costs, apart
    from the shape -> {route: ms, "picked": the route table_route takes}."""
    import numpy as np
    import torch

    from repro_torch.core.decision_table import fallback_decision_table
    from repro_torch.kernels.enrich_score import kernel

    dev = lut.device
    mode = name.rsplit("_", 1)[1]
    picked = kernel.table_route(mode, p, 2**f, 10, f, 4096)
    smem = (kernel.best_smem_bytes if mode == "best" else kernel.table_smem_bytes)(
        p, 2**f, 10, f, 4096)
    assert smem <= kernel.SMEM_LIMIT, (name, p, f, smem)
    table = fallback_decision_table(p, f, torch.linspace(0.6, 0.9, f)).to(dev)
    costs = torch.tensor(np.tile(np.linspace(0.05, 0.9, f), (p, 1)), dtype=torch.float32,
                         device=dev)
    pp, unc, sid, joint = _kernel_inputs(dev, torch.float32, False, 41, c, p, f, q)
    shape = (c, p) if mode == "single" else (q, c, p)
    outs = {r: tuple(torch.empty(shape, dtype=dt, device=dev) for dt in
                     (torch.float32, torch.int32, torch.float32, torch.float32))
            for r in kernel.ROUTES}
    cand = torch.rand((c,), device=dev) > 0.3

    def call(route):
        if mode == "best":
            kernel.launch_best(pp, unc, sid, joint, table.delta_h_all, costs, lut, outs[route],
                               route)
        elif mode == "table":
            kernel.launch_table(pp, unc, sid, joint, table.delta_h, table.next_fn, costs, lut,
                                outs[route], route)
        else:
            kernel.launch_single(pp, unc, sid, joint[0], cand, table.delta_h, table.next_fn,
                                 costs, lut, outs[route], route)

    for route in kernel.ROUTES:
        call(route)
    torch.cuda.synchronize()
    for a, b in zip(*outs.values()):
        assert torch.equal(a, b), f"{name}: the two routes differ at P {p} F {f}"
    ms = {route: _time_ms(functools.partial(call, route)) for route in kernel.ROUTES}
    print(f"[kernels] {name} both routes on the same inputs (f32, C={c} P={p} F={f} Q={q}, "
          f"10 bins, {smem} B, uncounted): smem {ms['smem']:.4f} ms, global "
          f"{ms['global']:.4f} ms ({ms['global'] / ms['smem']:.3f}x), outputs equal; "
          f"table_route: {picked}", flush=True)
    return {**ms, "picked": picked, "smem_bytes": smem}


def phase_session_functions(world, f: int) -> dict:
    """Best mode with ``f`` (8 or 10) tagging functions, whose table (P 4,
    2^f states, 10 bins) takes the "global" route: phase 3's churn trace through a CPU and a card session (plans,
    want-bits, answers and answer digest equal), then the session server
    at 1,048,576 rows for a few epochs, counts zeroed just before and read
    just after."""
    import torch

    from repro_torch.kernels.enrich_score import kernel, ops
    from repro_torch.launch import serve

    aucs, costs_f = {8: (SESSION8_AUCS, SESSION8_COSTS), 10: (SESSION10_AUCS, SESSION10_COSTS)}[f]
    tag = f"[session-{f}fn]"
    table, combine, costs, outputs = world
    t0 = time.perf_counter()
    ops.reset_counts()
    epochs, cpu_cost, gpu_cost = _run_trace_pair(table, combine, costs, outputs, "best")
    small = _es_counts(ops)
    assert small["enrich_score_best/global"] == small["enrich_score_best"] > 0, small
    print(f"{tag} CPU and card sessions agree over {epochs} best-mode epochs with {f} "
          f"functions (plans, merged plans, want-bits, answers, answer digest equal; spend "
          f"{cpu_cost!r} vs {gpu_cost!r}); card launches {small} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    session, state, pool, preds = serve.build_session_server(
        num_objects=SESSION_ROWS, capacity=SESSION_ROWS, num_preds=P, max_tenants=8,
        substrate_dtype="bfloat16", device="cuda", aucs=aucs, costs=costs_f)
    setup_s = time.perf_counter() - t0
    d_all = session.table.delta_h_all
    assert d_all.shape == (P, 2**f, 10, f), d_all.shape
    assert kernel.table_route("best", P, 2**f, 10, f, 4096) == "global"
    ops.reset_counts()
    report = serve.serve_session_trace(session, state, serve.parse_trace(SESSION8_TRACE),
                                       pool=pool, preds=preds)
    launches, plain = _es_counts(ops), dict(ops.PLAIN_CALLS)
    hist = report.history
    assert not any(plain.values()), f"plain path ran on the {f}-function session: {plain}"
    assert launches["enrich_score_best"] == report.epochs == SESSION8_EPOCHS, launches
    assert launches["enrich_score_best/global"] == report.epochs, launches
    spent = [h.cost_spent for h in hist]
    assert all(b > a for a, b in zip(spent, spent[1:])), "an epoch charged nothing"
    for h in hist:
        assert all(x == x and 0.0 <= x <= 1.0 for x in h.expected_f), h.expected_f
    assert torch.isfinite(report.state.derived.pred_prob.float()).all()
    assert _fold(report.state), "invoices do not fold to cost_spent"
    print(f"{tag} server at {report.num_rows} rows, {f} functions (delta_h_all "
          f"{d_all.numel() * 4} B): setup {setup_s:.2f} s; trace {SESSION8_TRACE!r}: "
          f"{report.epochs} epochs in {report.wall_s:.2f} s wall; cost_spent "
          f"{report.cost_spent!r}; mean E(F) {hist[0].mean_expected_f!r} -> "
          f"{hist[-1].mean_expected_f!r}; launches {launches}", flush=True)
    return launches


def _run_trace_pair(table, combine, costs, outputs, mode):
    """The smoke churn trace through a CPU and a CUDA session, epoch by epoch."""
    import numpy as np
    import torch

    from repro_torch.core.executor import EngineConfig
    from repro_torch.core.query import Predicate, conjunction
    from repro_torch.core.session import EngineSession
    from repro_torch.launch.serve import state_digests

    preds = [Predicate(i, 1) for i in range(P)]
    sessions, states = [], []
    for device in ("cpu", "cuda"):
        s = EngineSession(preds, table, combine, costs, capacity=2048, max_tenants=4,
                          max_capacity=4096, device=device,
                          config=EngineConfig(plan_size=64, function_selection=mode))
        sessions.append(s)
        states.append(s.init_state(outputs[:2048]))
    epochs = 0
    for kind, arg in SMOKE_TRACE:
        for i, s in enumerate(sessions):
            if kind == "admit":
                states[i], _ = s.admit(states[i], conjunction(*[preds[c] for c in arg]))
            elif kind == "ingest":
                states[i] = s.ingest(states[i], outputs[2048:2048 + arg])
            elif kind == "retire":
                states[i] = s.retire(states[i], arg)
        if kind != "run":
            continue
        for _ in range(arg):
            parts = [s.program._plan_part(st) for s, st in zip(sessions, states)]
            (cp, cm, cw), (gp, gm, gw) = [[x.cpu() if torch.is_tensor(x) else x.map(
                lambda t: t.cpu()) for x in part] for part in parts]
            for a, b in ((cp, gp), (cm, gm)):
                assert torch.equal(a.valid, b.valid), f"{mode} epoch {epochs}: plan validity"
                for x, y in zip(a[:3], b[:3]):
                    assert torch.equal(torch.where(a.valid, x, -1), torch.where(b.valid, y, -1)), (
                        f"{mode} epoch {epochs}: plan lanes differ")
            assert torch.equal(cw, gw), f"{mode} epoch {epochs}: want-bits differ"
            hist = []
            for i, s in enumerate(sessions):
                states[i], (h,) = s.run(states[i], 1, collect_masks=True,
                                        stop_when_exhausted=False)
                hist.append(h)
            hc, hg = hist
            assert np.array_equal(hc.answer_mask, hg.answer_mask), f"{mode} epoch {epochs}: answers"
            np.testing.assert_allclose(hg.cost_spent, hc.cost_spent, rtol=1e-5)
            np.testing.assert_allclose(hg.attributed, hc.attributed, rtol=1e-5, atol=1e-6)
            epochs += 1
    bills = [st.ledger.bills(st.cost_spent) for st in states]
    np.testing.assert_allclose(bills[1], bills[0], rtol=1e-5, atol=1e-6)
    digests = [state_digests(st)[2] for st in states]
    assert digests[0] == digests[1], f"{mode}: answer digests differ: {digests}"
    return epochs, hc.cost_spent, hg.cost_spent


def phase_cpu_vs_gpu(table, combine, costs, outputs):
    for mode in ("best", "table"):
        t0 = time.perf_counter()
        epochs, cpu_cost, gpu_cost = _run_trace_pair(table, combine, costs, outputs, mode)
        print(f"[session] {mode}: CPU and GPU sessions agree over {epochs} epochs (plans, "
              f"merged plans, want-bits, answers equal; spend {cpu_cost!r} vs {gpu_cost!r}) "
              f"in {time.perf_counter() - t0:.1f} s", flush=True)


def _fold(state) -> bool:
    import numpy as np

    acc = np.float32(np.float32(float(state.ledger.archived)) +
                     np.float32(float(state.ledger.unattributed)))
    for b in state.ledger.bills(state.cost_spent):
        acc = np.float32(acc + b)
    return acc == np.float32(float(state.cost_spent))


def phase_main_path() -> dict:
    import torch

    from repro_torch.core.executor import EngineConfig
    from repro_torch.core.session import EngineSession
    from repro_torch.kernels.enrich_score import ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import serve

    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    fa_ops.reset_counts()
    t0 = time.perf_counter()
    session, state, pool, preds = serve.build_session_server(
        num_objects=524288, capacity=524288, max_capacity=1 << 20, num_preds=P,
        max_tenants=8, substrate_dtype="bfloat16", device="cuda",
    )
    setup_s = time.perf_counter() - t0
    h_start = state.derived.uncertainty[:524288].float().mean().item()
    report = serve.serve_session_trace(session, state, serve.parse_trace(MAIN_TRACE),
                                       pool=pool, preds=preds)
    grown = report.state
    table_session = EngineSession(
        session.global_predicates, session.table, session.combine_params, session.costs,
        capacity=grown.capacity, max_tenants=8, device="cuda",
        config=EngineConfig(plan_size=64, substrate_dtype="bfloat16"),
    )
    t1 = time.perf_counter()
    final, table_hist = table_session.run(grown, 8, stop_when_exhausted=False)
    table_s = time.perf_counter() - t1
    launches, plain = _es_counts(ops), dict(ops.PLAIN_CALLS)
    assert not fa_ops.LAUNCHES["flash_attention"] and not fa_ops.PLAIN_CALLS["flash_attention"]
    peak = torch.cuda.max_memory_allocated()

    hist = report.history
    assert report.epochs == 24 and len(table_hist) == 8
    assert grown.capacity == 1 << 20 and report.num_rows == 1 << 20 and report.growths == 1
    assert launches == _es_expect(table=8, best=24), launches  # P 4, F 4: the smem route
    assert not any(plain.values()), f"plain path ran on the main path: {plain}"
    assert report.superstep_traces <= session.retrace_bound, report.superstep_traces
    assert _fold(grown) and _fold(final), "invoices do not fold to cost_spent"
    spent = [h.cost_spent for h in hist + table_hist]
    assert all(b > a for a, b in zip(spent, spent[1:])), "an epoch charged nothing"
    h_end = final.derived.uncertainty[:524288].float().mean().item()
    assert h_end < h_start, (h_start, h_end)
    for h in hist + table_hist:
        assert all(f == f and 0.0 <= f <= 1.0 for f in h.expected_f), h.expected_f
    assert torch.isfinite(final.derived.pred_prob.float()).all()
    assert final.derived.in_answer.shape == (8, 1 << 20)
    best_eps = report.epochs / report.wall_s
    print(f"[main] server setup {setup_s:.2f} s; trace {MAIN_TRACE!r}: {report.epochs} "
          f"epochs in {report.wall_s:.2f} s wall ({best_eps:.2f} epochs/s incl. churn events), "
          f"{report.num_rows} rows, tier {report.capacity}, {report.growths} growth, "
          f"chunk programs {report.superstep_traces} (bound {session.retrace_bound}), "
          f"cost_spent {report.cost_spent!r} ({report.cost_hex}), bills fold bitwise, "
          f"mean E(F) {hist[0].mean_expected_f!r} -> {hist[-1].mean_expected_f!r}, "
          f"mean entropy of the first 524288 rows {h_start!r} -> {h_end!r}",
          flush=True)
    print(f"[main] table mode on the grown state: 8 epochs in {table_s:.2f} s "
          f"({8 / table_s:.2f} epochs/s), mean E(F) {table_hist[-1].mean_expected_f:.6f}; "
          f"launches {launches}, plain calls {plain}; peak device memory "
          f"{peak / 2**30:.3f} GiB", flush=True)
    return launches


def _fa_bound(case) -> tuple:
    """(bound_ms, bound_by) of one attention call: q, k, v read once and o
    written once, against 4 * D operations per live (query, key) pair and
    head (the QK and PV products) at the inputs' type's peak rate."""
    import numpy as np

    b, sq, skv, h, kv, d, causal, window, _, dtype, kv_len, q_off = case
    esize = 2 if dtype == "bfloat16" else 4
    nbytes = esize * (2 * b * sq * h * d + 2 * b * skv * kv * d)
    kl = skv if kv_len is None else kv_len
    q_pos = np.arange(sq)[:, None] + (kl - sq if q_off else 0)
    k_pos = np.arange(skv)[None, :]
    live = np.broadcast_to(k_pos < kl, (sq, skv))
    if causal:
        live = live & (k_pos <= q_pos)
    if window is not None:
        live = live & (k_pos > q_pos - window)
    ops = 4.0 * d * b * h * float(live.sum())
    rate = BF16_OPS_PER_S if dtype == "bfloat16" else F32_OPS_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


_FLEX = []  # the compiled flex_attention, made on first use


def _flex_call(q, k, v, *, causal, window, cap, q_base):
    """The library call for a softcapped attention: ``flex_attention``
    compiled (once, by its first call: that call is never timed) over q / k
    / v [B, S, H, D], the tanh softcap as its score_mod and the causal /
    window mask (query i at position ``q_base + i``; keys > position -
    window) as its block mask -> a callable giving [B, H, Sq, D]."""
    import torch
    from torch.nn.attention.flex_attention import create_block_mask, flex_attention

    if not _FLEX:  # the compiler's caches inside the checkout's build directory
        build = Path(__file__).resolve().parent / "build"
        os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR", str(build / "torchinductor"))
        os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
        _FLEX.append(torch.compile(flex_attention, dynamic=False))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))

    def score_mod(score, b, h, q_idx, kv_idx):
        return cap * torch.tanh(score / cap)

    def mask_mod(b, h, q_idx, kv_idx):
        pos = q_idx + q_base
        ok = kv_idx <= pos if causal else kv_idx >= 0
        return ok & (kv_idx > pos - window) if window is not None else ok

    block_mask = None
    if causal or window is not None:
        block_mask = create_block_mask(mask_mod, None, None, qt.shape[2], kt.shape[2],
                                       device=q.device)
    return lambda: _FLEX[0](qt, kt, vt, score_mod=score_mod, block_mask=block_mask,
                            enable_gqa=True)


def _fa_other_call(q, k, v, kl, kw, kind, tanhf=False):
    """A call of the ``kind`` flash kernel (with ``tanhf``, the tc kernel
    built with the accurate tanh) that no count sees -> (call, its output)."""
    import torch

    from repro_torch.kernels.flash_attention import kernel

    out = torch.empty_like(q)

    def call():
        kernel.launch(q, k, v, kl, out, causal=kw["causal"], window=kw["window"],
                      softcap=kw["logit_softcap"], q_offset_from_kv_len=kw["q_offset_from_kv_len"],
                      kind=kind, tanhf=tanhf)

    return call, out


def _softcap_check(q, k, v, kl, want, kw, label, q_scale, tol, ms: bool) -> dict:
    """The tc kernel's softcap on these inputs, uncounted: its distance from
    the twin ``want`` (max abs) and from the twin in f32 (mean abs: below the
    bf16 output's rounding) as built (tanh.approx.f32), built with tanhf, and
    without the cap; with
    ``ms``, each one's time.  Where q is scaled so that the scores reach the
    cap, the kernel without it must differ from the twin beyond ``tol`` (else
    the case cannot tell a right softcap from a missing one) -> a row for the
    JSON line."""
    import torch

    from repro_torch.kernels.flash_attention import ops

    want_f32 = ops.plain_bshd(q.float(), k.float(), v.float(), kl, **kw)
    row = {"case": label, "q_scale": q_scale}
    runs = [("approx", False, kw), ("tanhf", True, kw),
            ("no_softcap", False, {**kw, "logit_softcap": None})]
    for name, tanhf, kw_run in runs:
        call, out = _fa_other_call(q, k, v, kl, kw_run, "tc", tanhf=tanhf)
        call()
        torch.cuda.synchronize()
        row[f"{name}_err"] = (out.float() - want.float()).abs().max().item()
        row[f"{name}_mean_err_f32"] = (out.float() - want_f32).abs().mean().item()
        within = torch.allclose(out.float(), want.float(), rtol=tol, atol=tol)
        row[f"{name}_within_tol"] = within
        if ms:
            row[f"{name}_ms"] = _time_ms(call)
    print(f"[flash] {label} softcap {kw['logit_softcap']}: max abs diff from the twin "
          + ", ".join(f"{n} {row[f'{n}_err']:.3g} (mean from f32 {row[f'{n}_mean_err_f32']:.4g}"
                      + (f", {row[f'{n}_ms']:.4f} ms)" if ms else ")") for n, _, _ in runs)
          + f" (tol {tol})", flush=True)
    assert row["approx_within_tol"], row  # the shipped build, as the counted call
    if q_scale > 1:
        assert not row["no_softcap_within_tol"], (
            f"{label}: the tc kernel without its softcap stays within {tol} of the twin, so "
            f"the cap does not bind here: {row}")
    return row


def _softcap_control(q, k, v, kl, want, kw, label, q_scale, tol, route) -> dict:
    """The short, split or simt kernel without its softcap on inputs whose scores
    reach the cap (uncounted): it must differ from the capped twin ``want``
    beyond ``tol``, or the case could not tell a right softcap from a
    missing one -> a row for the JSON line."""
    import torch

    call, out = _fa_other_call(q, k, v, kl, {**kw, "logit_softcap": None}, route)
    call()
    torch.cuda.synchronize()
    miss = (out.float() - want.float()).abs().max().item()
    print(f"[flash] {label} softcap {kw['logit_softcap']}: the {route} kernel without its cap "
          f"misses the twin by {miss:.3g} (tol {tol})", flush=True)
    assert not torch.allclose(out.float(), want.float(), rtol=tol, atol=tol), (
        f"{label}: the {route} kernel without its softcap stays within {tol} of the twin: the "
        "cap does not bind here")
    return {"case": label, "q_scale": q_scale, "no_softcap_err": miss}


def phase_flash() -> dict:
    """The four flash kernels against the plain twin (the split kernel
    against its own: the shares' partials, then their combine) -> {route:
    results}."""
    import torch
    import torch.nn.functional as tnf

    from repro_torch.kernels.flash_attention import kernel, ops

    dev = torch.device("cuda")
    results = {r: {"max_abs_err": 0.0} for r in kernel.ROUTE_NAMES}
    for case in FA_CASES:
        b, sq, skv, h, kv, d, causal, window, cap, dtype, kv_len, q_off, q_scale = (*case, 1.0)[:13]
        dt = getattr(torch, dtype)
        g = torch.Generator(device=dev).manual_seed(sq * 131 + d)
        q = (torch.randn((b, sq, h, d), generator=g, device=dev) * q_scale).to(dt)
        k = torch.randn((b, skv, kv, d), generator=g, device=dev).to(dt)
        v = torch.randn((b, skv, kv, d), generator=g, device=dev).to(dt)
        kl = None if kv_len is None else torch.full((1,), kv_len, dtype=torch.int32, device=dev)
        kw = dict(causal=causal, window=window, logit_softcap=cap, q_offset_from_kv_len=q_off)

        route = kernel.route(q.dtype, sq, d, h // kv, skv)
        ns = kernel.split_num_splits(b * kv, skv) if route == "split" else None

        def kernel_call():
            return ops.flash_attention(q, k, v, kl, **kw)

        def plain_call():
            return ops.plain_bshd(q, k, v, kl, num_splits=ns, **kw)

        before = ops.ROUTES[route]
        out, want = kernel_call(), plain_call()
        torch.cuda.synchronize()
        assert ops.ROUTES[route] == before + 1, (case, route, ops.ROUTES)
        err = (out.float() - want.float()).abs().max().item()
        tol = _binding_tol(FA_TOL[dtype], dtype, q_scale)
        if not torch.allclose(out.float(), want.float(), rtol=tol, atol=tol):
            raise AssertionError(f"flash_attention {case} ({route}): differs from the plain "
                                 f"twin beyond {tol} (max abs diff {err})")
        result = results[route]
        result["max_abs_err"] = max(result["max_abs_err"], err)
        label = (f"B={b} Sq={sq} Skv={skv} H={h} KV={kv} D={d} causal={causal} {dtype} "
                 f"kv_len={kv_len} q_scale={q_scale} ({route})")
        if route == "tc" and cap is not None:  # the softcap's tanh formula at these scores
            result.setdefault("softcap", []).append(
                _softcap_check(q, k, v, kl, want, kw, label, q_scale, FA_TOL[dtype], ms=(
                    d == 256 and window is None and sq == GEMMA2_GLOBAL_CAPPED[1])))
        elif cap is not None and q_scale > 1:  # short / split / simt where the cap binds
            result.setdefault("softcap", []).append(dict(
                _softcap_control(q, k, v, kl, want, kw, label, q_scale, tol, route), err=err))
        if case not in FA_TIMED:
            print(f"[flash] {label} window={window} softcap={cap}: "
                  f"max abs diff {err:.3g} (tol {tol})", flush=True)
            continue
        live = skv if kv_len is None else kv_len  # the library call over the live keys
        assert not causal or not q_off or live == sq  # its causal queries start at key 0
        if cap is None:
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k[:, :live], v[:, :live]))
            mask = None
            if window is not None:  # SDPA takes a window as a boolean mask (live == sq)
                pos = torch.arange(live, device=dev)
                mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)

            def library_call():
                return tnf.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                        is_causal=causal and mask is None,
                                                        enable_gqa=True)
            lib_name = "sdpa"
        else:  # SDPA does not softcap
            library_call = _flex_call(q, k[:, :live], v[:, :live], causal=causal,
                                      window=window, cap=cap, q_base=0)
            lib_name = "flex_attention"
        lib = library_call().transpose(1, 2)
        torch.cuda.synchronize()
        if not torch.allclose(lib.float(), want.float(), rtol=tol, atol=tol):
            raise AssertionError(f"{lib_name} disagrees at {label}")
        ms, plain_ms, library_ms = (_time_ms(f) for f in (kernel_call, plain_call, library_call))
        bound_ms, bound_by = _fa_bound(case)
        row = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                   library_ms=library_ms)
        print(f"[flash] {label} window={window} softcap={cap}: max abs diff {err:.3g} (tol "
              f"{tol}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, {lib_name} "
              f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
              f"{bound_ms / ms:.1%} of bound", flush=True)

        def time_other(kind):
            """The ``kind`` kernel on the same inputs (uncounted), held against
            the twin and timed -> ms."""
            other_call, out_other = _fa_other_call(q, k, v, kl, kw, kind)
            other_call()
            torch.cuda.synchronize()
            other_err = (out_other.float() - want.float()).abs().max().item()
            if not torch.allclose(out_other.float(), want.float(), rtol=tol, atol=tol):
                raise AssertionError(f"flash_attention {case} ({kind}): differs from the "
                                     f"plain twin beyond {tol} (max abs diff {other_err})")
            results[kind]["max_abs_err"] = max(results[kind]["max_abs_err"], other_err)
            other_ms = _time_ms(other_call)
            print(f"[flash] {label}: the {kind} kernel on the same inputs {other_ms:.4f} "
                  f"ms (max abs diff {other_err:.3g}), {bound_ms / other_ms:.1%} of bound",
                  flush=True)
            return other_ms

        if case in ZOO_FA:  # the zoo's shapes: a row each beside the route's own
            shape = dict(row, case=label, serves=ZOO_FA[case], window=window, softcap=cap,
                         library=lib_name)
            if route == "tc" and d not in kernel.SHORT_HEAD_DIMS:  # D 80 / 256: the simt
                shape["simt_ms"] = time_other("simt")  # kernel that took them before
            if route == "split":  # seamless's cross-attention decode: the short kernel
                shape["short_ms"] = time_other("short")  # took it before
                assert ms < shape["short_ms"], (
                    f"the split kernel ({ms:.4f} ms) is slower than the short kernel "
                    f"({shape['short_ms']:.4f} ms) at {label}")
                result.update(row, short_ms=shape["short_ms"])  # its JSON numbers
            result.setdefault("shapes", []).append(shape)
            continue
        # the kernels the route did not pick, on the same inputs (uncounted): why
        # the route.  tc, short and simt take bf16 at D 64 / 128 ("split" at most
        # 8 rows a kv head); "simt" alone takes f32.
        others = [r for r in kernel.ROUTE_NAMES if r not in (route, "split") and route != "simt"]
        for other in others:
            other_ms = time_other(other)
            if case == BACKBONE_FA and other == "simt":  # its numbers at the cascade's shape
                results["simt"].update(row, ms=other_ms)
                assert ms <= other_ms, (
                    f"the short kernel ({ms:.4f} ms) is slower than the simt kernel it "
                    f"replaces ({other_ms:.4f} ms) at the cascade's shape")
        if case == BACKBONE_FA:  # the cascade's shape and dtype
            result.update(row)
        elif case == PREFILL_FA:  # the qwen3 prefill's shape and dtype
            result.update(row)
            results["simt"].update(prefill_ms=ms, prefill_bound_ms=bound_ms,
                                   prefill_library_ms=library_ms)
    b, sq, skv, h, kv, d = BACKBONE_FA[:6]
    assert kernel.route(torch.bfloat16, sq, d, h // kv, skv) == "short"
    assert "ms" in results["split"], "no split case at seamless's cross-attention decode"
    return results


def _reduced_f32_backbone(arch):
    import dataclasses

    from repro_torch.configs.archs import get_config

    return dataclasses.replace(get_config(arch, smoke=True), dtype="float32")


def phase_cascade_cpu_vs_gpu(arch="qwen3-1.7b"):
    """The cascade bank built on the CPU, copied to the card; one churn trace
    through a CPU and a CUDA session, lockstep.  With the mamba2 backbone the
    plans and answer sets must be equal on every epoch."""
    import torch

    from repro_torch.core.query import conjunction
    from repro_torch.launch import serve

    # f32 products in full f32 on the card (PyTorch's default, stated here)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    preds, _, bank, combine, table, _ = serve._offline_phase(
        128, 3, _reduced_f32_backbone(arch), seed=0, device="cpu")
    banks = (bank, bank.to("cuda"))
    pairs = [serve.open_cascade_session(preds, b, combine, table, max_tenants=4, plan_size=32,
                                        device=b.device) for b in banks]
    sessions, states = [p[0] for p in pairs], [p[1] for p in pairs]
    epochs, trunk_epochs, worst, diverged = 0, 0, 0.0, []
    for kind, arg in CASCADE_SMOKE_TRACE:
        for i, s in enumerate(sessions):
            if kind == "admit":
                states[i], _ = s.admit(states[i], conjunction(*[preds[c] for c in arg]))
            elif kind == "retire":
                states[i] = s.retire(states[i], arg)
        if kind != "run":
            continue
        for _ in range(arg):
            (_, cm, _), (_, gm, _) = [s.program._plan_part(st) for s, st in zip(sessions, states)]
            gm_cpu = gm.map(lambda t: t.cpu())
            same_plan = torch.equal(cm.valid, gm_cpu.valid) and all(
                torch.equal(torch.where(cm.valid, x, -1), torch.where(gm_cpu.valid, y, -1))
                for x, y in zip(cm[:3], gm_cpu[:3]))
            if epochs == 0:
                assert same_plan, "cascade epoch 0: CPU and card plans differ"
            trunk_epochs += bool((cm.valid & (cm.func_idx == 2)).any())
            # the same merged plan through both banks: plain twins vs kernels
            want = banks[0].execute(cm)
            got = banks[1].execute(cm.map(lambda t: t.to("cuda"))).cpu()
            err = (got - want).abs().max().item()
            assert err <= 1e-5, f"cascade epoch {epochs}: execute differs by {err}"
            worst = max(worst, err)
            hist = []
            for i, s in enumerate(sessions):
                states[i], (h,) = s.run(states[i], 1, collect_masks=True,
                                        stop_when_exhausted=False)
                hist.append(h)
            same_answers = (hist[0].answer_mask == hist[1].answer_mask).all()
            if not (same_plan and same_answers):
                diverged.append(epochs)
                print(f"[cascade] epoch {epochs}: plans equal {same_plan}, answer sets equal "
                      f"{bool(same_answers)} (CPU vs card)", flush=True)
            epochs += 1
    assert trunk_epochs > 0, "the smoke trace never ran the trunk"
    if arch == "mamba2-370m":
        assert not diverged, f"mamba2 cascade: CPU and card differ on epochs {diverged}"
    print(f"[cascade] reduced f32 {arch} trunk, CPU vs card over {epochs} epochs ({trunk_epochs} ran the "
          f"trunk): execute agrees within {worst:.3g} (<= 1e-5), epoch-0 plans equal, "
          f"divergent epochs {diverged or 'none'}; in {time.perf_counter() - t0:.1f} s",
          flush=True)


def phase_operator_cpu_vs_gpu(world):
    """The quickstart operator at N = 4,096 on the CPU (plain twins) and the
    card (kernels), lockstep: the kernel route epoch by epoch through
    ``run_epoch`` (plans and answer sets), the session facade through
    one-epoch ``run`` calls (executed triples and answer sets)."""
    import numpy as np
    import torch

    from repro_torch.quickstart import quickstart_operator

    n = world["num_objects"]
    for fused in (True, False):
        t0 = time.perf_counter()
        pairs = [quickstart_operator(world, fused, device=d) for d in ("cpu", "cuda")]
        ops_, states = [p[0] for p in pairs], [p[1] for p in pairs]
        for e in range(24):
            if fused:
                out = [op.run_epoch(st) for op, st in zip(ops_, states)]
                states = [o[0] for o in out]
                (_, sc, pc, _), (_, sg, pg, _) = out
                pg = pg.map(lambda t: t.cpu())
                assert torch.equal(pc.valid, pg.valid), f"operator epoch {e}: plan validity"
                for x, y in zip(pc[:3], pg[:3]):
                    assert torch.equal(torch.where(pc.valid, x, -1), torch.where(pg.valid, y, -1)), (
                        f"operator epoch {e}: plan lanes differ")
                assert torch.equal(sc.mask, sg.mask.cpu()), f"operator epoch {e}: answers"
            else:
                states = [op.run(n, 1, state=st, stop_when_exhausted=False)[0]
                          for op, st in zip(ops_, states)]
                assert torch.equal(states[0].exec_mask, states[1].exec_mask.cpu()), (
                    f"facade epoch {e}: executed triples differ")
                assert torch.equal(states[0].in_answer, states[1].in_answer.cpu()), (
                    f"facade epoch {e}: answers")
            np.testing.assert_allclose(float(states[1].cost_spent), float(states[0].cost_spent),
                                       rtol=1e-5)
        route = "kernel route (fused_benefits)" if fused else "session facade"
        print(f"[operator] {route}: CPU and GPU operators agree over 24 epochs at N={n} "
              f"(plans and answers equal; spend {float(states[0].cost_spent)!r} vs "
              f"{float(states[1].cost_spent)!r}) in {time.perf_counter() - t0:.1f} s", flush=True)


def phase_operator_main_path() -> dict:
    """The paper's operator at 1,048,576 objects: the kernel route, then the
    session facade; counts zeroed before each run and read after it."""
    import torch

    from repro_torch.kernels.enrich_score import ops
    from repro_torch.quickstart import quickstart_operator, quickstart_world

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    world = quickstart_world(N_OP, train_size=1024, device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    launches = dict.fromkeys(_es_counts(ops), 0)
    lines = []
    for fused in (True, False):
        op, st0 = quickstart_operator(world, fused, device="cuda")
        h_start = st0.uncertainty.mean().item()
        ops.reset_counts()
        t1 = time.perf_counter()
        final, hist = op.run(N_OP, OP_EPOCHS, state=st0, stop_when_exhausted=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        run_launches, plain = _es_counts(ops), dict(ops.PLAIN_CALLS)
        assert len(hist) == OP_EPOCHS, len(hist)
        assert not any(plain.values()), f"plain path ran on the operator path: {plain}"
        # P 2, F 4: the smem route
        if fused:
            assert run_launches == _es_expect(single=OP_EPOCHS), run_launches
        else:
            assert run_launches == _es_expect(table=OP_EPOCHS), run_launches
        for k, v in run_launches.items():
            launches[k] += v
        live = [h for h in hist if h.plan_valid > 0]
        spent = [h.cost_spent for h in live]
        assert len(live) == OP_EPOCHS and all(b > a for a, b in zip(spent, spent[1:])), (
            "an epoch charged nothing")
        h_end = final.uncertainty.mean().item()
        assert h_end < h_start, (h_start, h_end)
        assert all(0.0 <= h.expected_f <= 1.0 for h in hist), [h.expected_f for h in hist]
        assert torch.isfinite(final.pred_prob).all() and final.in_answer.shape == (N_OP,)
        route = "kernel route (fused_benefits)" if fused else "session facade"
        lines.append(
            f"[operator-main] {route}: {OP_EPOCHS} epochs in {wall:.3f} s = "
            f"{wall / OP_EPOCHS * 1e3:.3f} ms/epoch (host clock, synchronised at the end); "
            f"launches {run_launches}; cost_spent {hist[-1].cost_spent!r}; E(F) "
            f"{hist[0].expected_f!r} -> {hist[-1].expected_f!r}; true F1 {hist[0].true_f1!r} -> "
            f"{hist[-1].true_f1!r}; mean entropy {h_start!r} -> {h_end!r}")
    peak = torch.cuda.max_memory_allocated()
    print(f"[operator-main] quickstart query, {N_OP} objects + 1024 to train, P=2, F=4, "
          f"OperatorConfig() defaults, preprocess_cheapest warm start; setup {setup_s:.2f} s; "
          f"peak device memory {peak / 2**30:.3f} GiB", flush=True)
    for line in lines:
        print(line, flush=True)
    return launches


def phase_serve_entry_points() -> dict:
    """``launch/serve.py``'s single-query and multi-query modes on the card."""
    from repro_torch.kernels.enrich_score import ops
    from repro_torch.launch import serve

    launches = dict.fromkeys(_es_counts(ops), 0)
    base = ["--objects", "512", "--preds", "2", "--epochs", "8", "--backbone", ""]
    for extra in ([], ["--queries", "4"]):
        ops.reset_counts()
        rc = serve.main(base + extra)
        assert rc == 0, f"serve {extra} returned {rc}"
        assert not any(ops.PLAIN_CALLS.values()), ops.PLAIN_CALLS
        if extra:  # the multi-query server scores in best mode
            assert ops.LAUNCHES["enrich_score_best"] > 0, ops.LAUNCHES
        for k, v in _es_counts(ops).items():
            launches[k] += v
        print(f"[serve] {' '.join(base + extra)!r}: rc 0, launches {dict(ops.LAUNCHES)}",
              flush=True)
    return launches


def phase_cascade_main_path(arch="qwen3-1.7b") -> dict:
    """Phase 5: the cascade server at full width with the ``arch`` trunk
    (qwen3-1.7b, mamba2-370m or hymba-1.5b) serves ``CASCADE_TRACE``."""
    import torch

    from repro_torch.kernels.enrich_score import ops as es_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssm_mixer import ops as mixer_ops
    from repro_torch.launch import serve

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    session, state, preds, qualities = serve.build_cascade_session_server(
        num_objects=2048, num_preds=3, max_tenants=8, backbone_arch=arch,
        plan_size=64, substrate_dtype="float32", smoke=False, train_size=512, device="cuda",
    )
    torch.cuda.synchronize()
    offline_s = time.perf_counter() - t0
    bank = session.bank
    trunk = bank.cascades[0][2].params[0]
    cfg = bank.cascades[0][2].cfg
    s_cfg = cfg.ssm
    if arch == "qwen3-1.7b":
        assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                cfg.d_ff) == (28, 2048, 16, 8, 128, 6144), cfg
        assert trunk["layers"][0]["attn"]["wq"].shape == (28, 2048, 16, 128)
        kernel_names, width = ("flash_attention",), (
            "28 layers, d_model 2048, 16/8 heads, D 128, bf16 trunk")
    elif arch == "mamba2-370m":
        assert (cfg.num_layers, cfg.d_model, s_cfg.state_dim, s_cfg.head_dim, s_cfg.expand,
                s_cfg.conv_width, s_cfg.chunk_size) == (48, 1024, 128, 64, 2, 4, 256), cfg
        assert trunk["layers"][0]["ssm"]["in_proj"].shape == (48, 1024, 4384)
        kernel_names, width = ("ssd_intra_chunk",) + MIXER_KERNELS, (
            "48 layers, d_model 1024, 32 SSD heads, P 64, N 128, bf16 trunk")
    else:  # hymba: a flash, an SSD and the mixer's two launches in every layer
        assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                s_cfg.state_dim, s_cfg.head_dim, s_cfg.num_heads(cfg.d_model)) == (
                    32, 1600, 25, 5, 64, 16, 64, 50), cfg
        assert trunk["layers"][0]["ssm"]["in_proj"].shape == (32, 1600, 6482)
        kernel_names, width = ("flash_attention", "ssd_intra_chunk") + MIXER_KERNELS, (
            "32 layers, d_model 1600, 25/5 heads of D 64 beside 50 SSD heads of P 64, N 16, "
            "bf16 trunk")
    epoch_marks, trunk_marks = [], []

    def on_chunk():  # one chunk per epoch: time it and note the trunk
        torch.cuda.synchronize()
        epoch_marks.append(time.perf_counter())
        trunk_marks.append(bank.trunk_runs)

    for counted in (es_ops, fa_ops, ssd_ops, mixer_ops):
        counted.reset_counts()
    syncs0, trunk0 = bank.bank_syncs, bank.trunk_runs
    t1 = time.perf_counter()
    epoch_marks.append(t1)
    trunk_marks.append(trunk0)
    report = serve.serve_session_trace(session, state, serve.parse_trace(CASCADE_TRACE),
                                       preds=preds, chunk_size=1, boundary_hook=on_chunk)
    launches = {**_es_counts(es_ops), **fa_ops.LAUNCHES, **ssd_ops.LAUNCHES,
                **mixer_ops.LAUNCHES,
                **{f"flash_attention/{r}": n for r, n in fa_ops.ROUTES.items()},
                **{f"ssd_intra_chunk/{r}": n for r, n in ssd_ops.ROUTES.items()}}
    plain = {**es_ops.PLAIN_CALLS, **fa_ops.PLAIN_CALLS, **ssd_ops.PLAIN_CALLS,
             **mixer_ops.PLAIN_CALLS}
    peak = torch.cuda.max_memory_allocated()
    trunk_epochs = bank.trunk_runs - trunk0
    st, hist = report.state, report.history

    assert report.epochs == 96, report.epochs
    assert trunk_epochs >= 4, f"the trunk ran on {trunk_epochs} epochs (< 4)"
    for name in kernel_names:
        assert launches[name] == cfg.num_layers * trunk_epochs, (launches, trunk_epochs)
    other = {"flash_attention", "ssd_intra_chunk", *MIXER_KERNELS} - set(kernel_names)
    assert not any(launches[k] for k in other), launches
    # the cascade's 8-token blocks take the short flash kernel and the packed SSD kernel
    assert fa_ops.ROUTES == {"tc": 0, "short": launches["flash_attention"], "split": 0,
                             "simt": 0}, fa_ops.ROUTES
    assert ssd_ops.ROUTES == {"tc": 0, "simt": 0, "packed": launches["ssd_intra_chunk"]}, (
        ssd_ops.ROUTES)
    # a block of 8 tokens is one chunk with no state entering it: nothing to add
    assert launches["ssd_inter_chunk"] == 0, launches
    assert launches["enrich_score_best"] == report.epochs and not launches["enrich_score_table"]
    assert launches["enrich_score_best/smem"] == report.epochs, launches  # P 3, F 3
    assert not any(plain.values()), f"plain path ran on the cascade main path: {plain}"
    assert bank.bank_syncs - syncs0 == report.epochs  # the one host read per epoch
    bound = max(len(report.scan_lengths), 1) * (report.growths + 1)
    assert report.superstep_traces <= bound, (report.superstep_traces, bound)
    assert _fold(st), "cascade invoices do not fold to cost_spent"
    spent = [h.cost_spent for h in hist]
    assert all(b > a for a, b in zip(spent, spent[1:])), "a cascade epoch charged nothing"
    for t in (st.substrate.func_probs, st.derived.pred_prob.float()):
        assert torch.isfinite(t).all() and ((t >= 0) & (t <= 1)).all()
    for h in hist:
        assert all(f == f and 0.0 <= f <= 1.0 for f in h.expected_f), h.expected_f
    steps = [b - a for a, b in zip(epoch_marks, epoch_marks[1:])]
    ran = [b > a for a, b in zip(trunk_marks, trunk_marks[1:])]
    first = ran.index(True)
    with_trunk = [t for t, r in zip(steps, ran) if r]
    without = [t for t, r in zip(steps, ran) if not r]
    print(f"[cascade-main] {arch} at full width ({width}), 2048 objects, 3 predicates x 3 "
          f"levels, 8 slots: offline phase {offline_s:.2f} s; AUCs {qualities}", flush=True)
    print(f"[cascade-main] trace {CASCADE_TRACE!r}: {report.epochs} epochs in "
          f"{report.wall_s:.2f} s; the planner first picked backbone lanes at epoch {first}; "
          f"{trunk_epochs} epochs ran the trunk at {statistics.median(with_trunk) * 1e3:.3f} ms "
          f"median, {len(without)} did not at {statistics.median(without) * 1e3:.3f} ms median "
          f"(host clock, synchronised per epoch)", flush=True)
    print(f"[cascade-main] launches {launches}, plain calls {plain}, bank host reads "
          f"{bank.bank_syncs - syncs0}; chunk programs {report.superstep_traces} (bound "
          f"{bound}); cost_spent {report.cost_spent!r} ({report.cost_hex}), bills fold "
          f"bitwise; mean E(F) {hist[0].mean_expected_f!r} -> {hist[-1].mean_expected_f!r}; "
          f"peak device memory {peak / 2**30:.3f} GiB", flush=True)
    return launches


def _ssd_inputs(b, s, h, n, dev, seed):
    """Model-layout SSD operands (H heads of P 64, state N): x, B and C slices
    of one bf16 projection, dt f32, a [H] read with a batch stride of 0."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    xbc = torch.randn((b, s, h * SSD_P + 2 * n), generator=g, device=dev)
    xbc = xbc.to(torch.bfloat16)
    x = xbc[..., :h * SSD_P].reshape(b, s, h, SSD_P)
    bm, cm = xbc[..., h * SSD_P:h * SSD_P + n], xbc[..., h * SSD_P + n:]
    dt = torch.rand((b, s, h), generator=g, device=dev) * 0.099 + 0.001
    a = -torch.arange(1, h + 1, dtype=torch.float32, device=dev)  # -exp(A_log) at init
    return x, dt, a[None].expand(b, h), bm, cm


def _ssd_bound(b, s, chunk, final_state, h, n) -> tuple:
    """(bound_ms, bound_by): x, B, C (bf16), dt (f32) read once, y, the kept
    states and cumexp (f32) written once; the operations C.B^T and W.X over
    the live lower triangle and X^T.B for each kept state, at the bf16 rate."""
    p = SSD_P
    nc = s // chunk
    kept = nc if final_state else nc - 1
    nbytes = (2 * b * s * h * p + 2 * 2 * b * s * n + 4 * b * s * h + 4 * h
              + 4 * b * s * h * p + 4 * b * h * kept * p * n + 4 * b * h * s)
    tri = chunk * (chunk + 1) // 2
    ops = b * h * (nc * tri * 2 * (n + p) + kept * chunk * 2 * p * n)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / BF16_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations"), nbytes


def _ssd_hold(name, got, want, result,
              labels=("y_intra", "s_contrib", "cumexp")) -> str:
    """Every output within SSD_TOL of its largest magnitude (an output the
    twin leaves out, None, is left out too) -> a summary."""
    errs = []
    for label, g, w in zip(labels, got, want):
        assert (g is None) == (w is None), (name, label)
        if w is None:
            continue
        assert g.shape == w.shape, (label, g.shape, w.shape)
        if not w.numel():
            continue
        err = (g - w).abs().max().item()
        scale = w.abs().max().item()
        if not err <= SSD_TOL * max(scale, 1.0):
            raise AssertionError(f"{name}: {label} differs from the plain twin by {err} (scale "
                                 f"{scale}, tol {SSD_TOL} x scale)")
        errs.append(f"{label} {err:.3g} of {scale:.3g}")
        result["max_abs_err"] = max(result["max_abs_err"], err)
    return "; ".join(errs)


def phase_ssd() -> tuple:
    """Kernel 6 against its plain twin at the mamba2 and hymba prefills (the
    "tc" route at N 128 and N 16, each beside the "simt" kernel on the same
    inputs, uncounted, which must be the slower), the cascade shapes (the
    "packed" route) and hymba's cascade trunk ("packed") -> (ssd_scan.cu
    results, tc results)."""
    import torch

    from repro_torch.kernels.ssd_scan import kernel, ops, ref

    dev = torch.device("cuda")
    results = {"ssd_intra_chunk": {"max_abs_err": 0.0}, "ssd_intra_chunk_tc": {"max_abs_err": 0.0}}
    for b, s, chunk, final, h, n in SSD_CASES:
        args = _ssd_inputs(b, s, h, n, dev, seed=s + n)
        route = kernel.route(args[0].dtype, chunk, SSD_P, n)
        name = "ssd_intra_chunk_tc" if route == "tc" else "ssd_intra_chunk"

        def kernel_call():
            return ops.intra_chunk(*args, chunk=chunk, final_state=final)

        def plain_call():
            return ref.intra_chunk_bshp(*args, chunk=chunk, final_state=final)

        before = ops.ROUTES[route]
        got, want = kernel_call(), plain_call()
        torch.cuda.synchronize()
        assert ops.ROUTES[route] == before + 1, (route, ops.ROUTES)
        label = (f"B={b} S={s} H={h} P={SSD_P} N={n} chunk={chunk} bf16, final state "
                 f"{final} ({route})")
        errs = _ssd_hold(label, got, want, results[name])
        ms, plain_ms = _time_ms(kernel_call), _time_ms(plain_call)
        (bound_ms, bound_by), nbytes = _ssd_bound(b, s, chunk, final, h, n)
        print(f"[ssd] {label}: max abs diff {errs}; kernel {ms:.4f} ms, plain {plain_ms:.4f} "
              f"ms, bound {bound_ms:.4f} ms ({bound_by}, {nbytes / 1e6:.1f} MB), "
              f"{bound_ms / ms:.1%} of bound", flush=True)
        row = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                   library_ms=None)
        if route == "tc":  # a prefill: the simt kernel on the same inputs, uncounted
            out = [torch.empty_like(t) for t in got]

            def simt_call():
                kernel.launch(*args, *out, chunk=chunk, kind="simt")

            simt_call()
            torch.cuda.synchronize()
            simt_errs = _ssd_hold(f"{label} (simt)", out, want, results["ssd_intra_chunk"])
            row["simt_ms"] = _time_ms(simt_call)
            print(f"[ssd] {label}: the simt kernel on the same inputs {row['simt_ms']:.4f} ms "
                  f"(max abs diff {simt_errs}), bound {bound_ms:.4f} ms ({bound_by}), "
                  f"{bound_ms / row['simt_ms']:.1%} of bound", flush=True)
            assert ms < row["simt_ms"], (
                f"the tc kernel ({ms:.4f} ms) is slower than the simt kernel "
                f"({row['simt_ms']:.4f} ms) at {label}")
        if n != 128:  # hymba's shapes: a row each beside the route's own
            results[name].setdefault("shapes", []).append(dict(row, case=label))
        elif route == "tc":  # the mamba2 prefill: the table's row
            results[name].update(row)
            results["ssd_intra_chunk"].update(prefill_simt_ms=row["simt_ms"],
                                              prefill_bound_ms=bound_ms)
        elif not final:  # the cascade's main-path form: the table's row
            results[name].update(row)
    return results["ssd_intra_chunk"], results["ssd_intra_chunk_tc"]


def _inter_bound(b, s, chunk, h, n, with_h0, final, c_bytes=2, p=SSD_P) -> tuple:
    """(bound_ms, bound_by), bytes: the inter-chunk function reads y_intra,
    cumexp and C on the rows a state enters (every chunk with h0, all but
    the first without), each kept state S_i and h0 once, and writes y on
    those rows and the final state once; its products, C.h on those rows,
    are two bf16 tensor-core products (h split hi + lo)."""
    nc = s // chunk
    kept = nc if final else nc - 1
    rows = s if with_h0 else s - chunk
    nbytes = (2 * 4 * b * rows * h * p + 4 * b * h * kept * p * n + 4 * b * h * rows
              + c_bytes * b * rows * n + 4 * b * h * p * n * (int(with_h0) + int(final)))
    ops = 2 * 2 * b * h * rows * p * n
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / BF16_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations"), nbytes


def phase_ssd_inter() -> dict:
    """Kernel 6's inter-chunk recurrence (``csrc/ssd_inter_chunk.cu``) against
    its plain twin (``ref.inter_chunk_bshp``, the loop over chunks) at
    ``INTER_CASES``, each counted launch adding into a copy of y_intra in
    place, y and the final state within SSD_TOL of their scale; timed beside
    its bound and the twin -> results (the mamba2 prefill's row, the others
    in ``shapes``)."""
    import torch

    from repro_torch.kernels.ssd_scan import kernel, ops, ref

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    result = {"max_abs_err": 0.0}
    for i, (b, s, chunk, h, n, with_h0, final) in enumerate(INTER_CASES):
        x, dt, a, bm, cm = _ssd_inputs(b, s, h, n, dev, seed=s + n)
        y_intra, s_contrib, cumexp = ops.intra_chunk(x, dt, a, bm, cm, chunk=chunk,
                                                     final_state=final)
        h0 = (torch.randn((b, h, SSD_P, n), generator=torch.Generator(device=dev).manual_seed(s),
                          device=dev) if with_h0 else None)
        want = ref.inter_chunk_bshp(y_intra, s_contrib, cumexp, cm, h0, chunk=chunk,
                                    final_state=final)
        y = y_intra.clone()
        before = ops.LAUNCHES["ssd_inter_chunk"]
        got = ops.inter_chunk(y, s_contrib, cumexp, cm, h0, chunk=chunk, final_state=final)
        torch.cuda.synchronize()
        assert ops.LAUNCHES["ssd_inter_chunk"] == before + 1, ops.LAUNCHES
        assert got[0].data_ptr() == y.data_ptr(), "the kernel writes y_intra in place"
        layout = kernel.inter_layout(b, h, SSD_P, sms)
        label = (f"B={b} S={s} H={h} P={SSD_P} N={n} chunk={chunk} ({s // chunk} chunks) bf16 "
                 f"C, h0 {'given' if with_h0 else 'none'}, final state {final}, {layout[0]} "
                 f"warps a block, {layout[1]} on rows")
        errs = _ssd_hold(label, got, want, result, INTER_OUTPUTS)
        hf = torch.empty_like(got[1]) if final else None

        def kernel_call():  # adds into y again on each call: the time is the same
            kernel.launch_inter(y, s_contrib, cumexp, cm, h0, hf, chunk=chunk, layout=layout)

        def plain_call():
            return ref.inter_chunk_bshp(y_intra, s_contrib, cumexp, cm, h0, chunk=chunk,
                                        final_state=final)

        ms, plain_ms = _time_ms(kernel_call), _time_ms(plain_call)
        (bound_ms, bound_by), nbytes = _inter_bound(b, s, chunk, h, n, with_h0, final)
        print(f"[ssd-inter] {label}: max abs diff {errs}; kernel {ms:.4f} ms, plain (the loop) "
              f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}, {nbytes / 1e6:.1f} MB), "
              f"{bound_ms / ms:.1%} of bound", flush=True)
        row = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                   library_ms=None)
        if i == 0:  # the mamba2 prefill: the table's row
            result.update(row)
        else:
            result.setdefault("shapes", []).append(dict(row, case=label))
        del x, dt, a, bm, cm, y_intra, s_contrib, cumexp, h0, y, got, want
    torch.cuda.empty_cache()
    return result

def _mixer_inputs(arch, b, s, tail, dev, seed):
    """The front's operands at ``arch``'s published widths: a bf16 projection
    (unit-normal x 2), conv_w / conv_b / dt_bias in f32 (one dt bias past
    softplus's threshold of 20), the conv tail [B, W-1, C] or None ->
    ((di, N, H, P, W, eps), proj, conv_w, conv_b, dt_bias, tail)."""
    import torch

    from repro_torch.configs.archs import get_config

    cfg = get_config(arch)
    sc = cfg.ssm
    di, n, h = sc.d_inner(cfg.d_model), sc.state_dim, sc.num_heads(cfg.d_model)
    c, width = di + 2 * n, sc.conv_width
    g = torch.Generator(device=dev).manual_seed(seed)
    proj = torch.empty((b, s, 2 * di + 2 * n + h), dtype=torch.bfloat16, device=dev)
    for r in range(b):  # a row at a time: no f32 copy of the whole projection
        proj[r] = torch.randn(proj.shape[1:], generator=g, device=dev) * 2
    dt_bias = torch.randn((h,), generator=g, device=dev) * 3
    dt_bias[0] = 25.0
    tl = (torch.randn((b, width - 1, c), generator=g, device=dev).to(torch.bfloat16) if tail
          else None)
    return ((di, n, h, sc.head_dim, width, cfg.rmsnorm_eps), proj,
            torch.randn((width, c), generator=g, device=dev) * 0.5,
            torch.randn((c,), generator=g, device=dev) * 0.1, dt_bias, tl)


def _mixer_bounds(b, s, di, n, h, width, tail) -> tuple:
    """((front bound_ms, bound_by), front bytes, (norm bound_ms, bound_by),
    norm bytes): each input read once, each output written once (bf16
    activations, f32 parameters and dt), against the f32 operations (the
    conv's 2 W a channel and its SiLU; SiLU(z); softplus; the norm's ~8 a
    value) at the f32 rate."""
    c = di + 2 * n
    tails = 2 * 2 * b * (width - 1) * c if tail else 0
    front_bytes = (2 * b * s * (2 * di + 2 * n + h) + 4 * (width * c + c + h)
                   + 2 * b * s * (c + di) + 4 * b * s * h + tails)
    front_ops = b * s * (c * (2 * width + 4) + 4 * di + 4 * h)
    norm_bytes = 2 * b * s * di * 4 + 4 * (h + di)
    norm_ops = b * s * di * 8
    out = []
    for nbytes, ops in ((front_bytes, front_ops), (norm_bytes, norm_ops)):
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
        out += [(t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations"), nbytes]
    return tuple(out)


def _ulps(got, want):
    """Units in the last place between two tensors of one dtype (bf16 or f32),
    elementwise, as int64 (0 where bitwise, 1 for neighbouring values across
    zero too)."""
    import torch

    assert got.dtype == want.dtype and got.dtype in (torch.bfloat16, torch.float32), (
        got.dtype, want.dtype)
    bits = torch.int16 if got.dtype == torch.bfloat16 else torch.int32
    top = -(1 << (8 * got.element_size() - 1))

    def ordered(t):  # sign-magnitude bits -> integers in the values' order
        i = t.contiguous().view(bits).long()
        return torch.where(i >= 0, i, top - i)

    return (ordered(got) - ordered(want)).abs()


def phase_mixer() -> dict:
    """The Mamba-2 mixer's two kernels (``csrc/ssm_mixer.cu``) against their
    twins (``ssm_mixer/ref.py``, the eager chain) at ``MIXER_CASES``: the
    front's xbc, gate, dt and new tail bitwise, the gated norm within
    ``MIXER_NORM_ULPS`` ulp (the share of values apart printed); each case's
    controls must miss (the front with the conv's taps reversed, the norm
    without its gate; uncounted launches); each kernel timed beside its
    bytes bound and its twin (the twins alone, at the prefill_32k layer
    SSD_BLOCK rows at a time, apart from the comparisons) -> results by
    kernel name (phase 7's shape the table's row, the others in
    ``shapes``)."""
    import torch

    from repro_torch.kernels.ssm_mixer import kernel, ops, ref

    dev = torch.device("cuda")
    fronts = ("xbc", "gate", "dt", "new_tail")
    results = {ops.FRONT: {"max_abs_err": 0.0}, ops.NORM: {"max_abs_err": 0.0}}
    for i, (label, arch, b, s, tail) in enumerate(MIXER_CASES):
        (di, n, h, p, width, eps), proj, w, bias, dt_bias, tl = _mixer_inputs(arch, b, s, tail,
                                                                             dev, seed=i)
        big = s >= 32768  # the prefill_32k layer: the twins a block of rows at a time
        step = SSD_BLOCK if big else b

        def front_call():
            return ops.front(proj, w, bias, dt_bias, d_inner=di, state_dim=n, cache_tail=tl,
                             new_tail=tail)

        def front_twin(rs=slice(None)):
            return ref.front(proj[rs], w, bias, dt_bias, di, n, None if tl is None else tl[rs])

        def blocks(twin):  # the twin over every batch row, ``step`` at a time, its outputs dropped
            def run():
                for r0 in range(0, b, step):
                    twin(slice(r0, r0 + step))
            return run

        before = dict(ops.LAUNCHES)
        got = front_call()
        torch.cuda.synchronize()
        assert ops.LAUNCHES[ops.FRONT] == before[ops.FRONT] + 1, ops.LAUNCHES
        apart, most = dict.fromkeys(fronts, 0), dict.fromkeys(fronts, 0)
        for r0 in range(0, b, step):
            rs = slice(r0, r0 + step)
            for name, g_, w_ in zip(fronts, got, front_twin(rs)):
                if g_ is None:
                    continue
                u = _ulps(g_[rs], w_)
                apart[name] += int((u > 0).sum())
                most[name] = max(most[name], int(u.max()))
                results[ops.FRONT]["max_abs_err"] = max(
                    results[ops.FRONT]["max_abs_err"],
                    (g_[rs].double() - w_.double()).abs().max().item())
        assert not any(apart.values()), (
            f"{label}: the front kernel differs from its twin: values apart {apart}, most ulps "
            f"{most}")
        # control: the conv's taps reversed must miss the twin
        ctl = [None if t is None else torch.empty_like(t) for t in got]
        kernel.launch_front(proj, tl, w.flip(0).contiguous(), bias, dt_bias, *ctl, d_inner=di)
        torch.cuda.synchronize()
        assert not torch.equal(ctl[0], got[0]), f"{label}: the reversed-taps control matched"
        del ctl

        # the norm on the front's xbc and gate, a random y, D and norm_w
        g = torch.Generator(device=dev).manual_seed(100 + i)
        y = torch.empty((b, s, h, p), dtype=torch.bfloat16, device=dev)
        for r in range(b):
            y[r] = torch.randn(y.shape[1:], generator=g, device=dev)
        d_skip = torch.randn((h,), generator=g, device=dev)
        norm_w = 1 + 0.1 * torch.randn((di,), generator=g, device=dev)
        x_in, gate = got[0][..., :di].reshape(b, s, h, p), got[1]

        def norm_call(gate=gate):
            return ops.gated_norm(y, x_in, d_skip, gate, norm_w, eps)

        def norm_twin(rs=slice(None), gate=gate):
            return ref.gated_norm(y[rs], x_in[rs], d_skip, gate[rs], norm_w, eps)

        before = dict(ops.LAUNCHES)
        out = norm_call()
        torch.cuda.synchronize()
        assert ops.LAUNCHES[ops.NORM] == before[ops.NORM] + 1, ops.LAUNCHES
        ctl = torch.empty_like(out)
        kernel.launch_gated_norm(y, x_in, torch.ones_like(gate), d_skip, norm_w, ctl, eps=eps)
        torch.cuda.synchronize()
        norm_apart, norm_most, ctl_most = 0, 0, 0
        for r0 in range(0, b, step):
            rs = slice(r0, r0 + step)
            want = norm_twin(rs)
            u = _ulps(out[rs], want)
            norm_apart += int((u > 0).sum())
            norm_most = max(norm_most, int(u.max()))
            ctl_most = max(ctl_most, int(_ulps(ctl[rs], want).max()))
            results[ops.NORM]["max_abs_err"] = max(
                results[ops.NORM]["max_abs_err"],
                (out[rs].double() - want.double()).abs().max().item())
        assert norm_most <= MIXER_NORM_ULPS, (
            f"{label}: the norm kernel is {norm_most} ulps from its twin "
            f"(> {MIXER_NORM_ULPS}; {norm_apart} values apart)")
        assert ctl_most > MIXER_NORM_ULPS, f"{label}: the norm without its gate matched"
        del ctl

        timing = dict(reps=5, warmup=1, inner=1) if big else {}
        front_ms, norm_ms = _time_ms(front_call, **timing), _time_ms(norm_call, **timing)
        twin_timing = dict(reps=3, warmup=0, inner=1) if big else {}
        front_twin_ms = _time_ms(blocks(front_twin), **twin_timing)
        norm_twin_ms = _time_ms(blocks(norm_twin), **twin_timing)
        fb, fbytes, nb, nbytes = _mixer_bounds(b, s, di, n, h, width, tail)
        shape = (f"{label}: {arch} B={b} S={s} di={di} N={n} H={h} W={width} bf16, tail "
                 f"{'in and out' if tail else 'none'}")
        print(f"[mixer] {shape}; front: xbc, gate, dt, tail bitwise the "
              f"twin (values apart {apart}); reversed-taps control missed; kernel "
              f"{front_ms:.4f} ms, twin {front_twin_ms:.4f} ms"
              f"{f' ({step} rows at a time)' if big else ''}, bound {fb[0]:.4f} ms ({fb[1]}, "
              f"{fbytes / 1e6:.1f} MB), {fb[0] / front_ms:.1%} of bound", flush=True)
        print(f"[mixer] {shape}; gated norm: {norm_apart} of {out.numel()} values "
              f"({norm_apart / out.numel():.3%}) apart from the twin, at most {norm_most} ulp "
              f"(<= {MIXER_NORM_ULPS}); without its gate {ctl_most} ulps (missed); kernel "
              f"{norm_ms:.4f} ms, twin {norm_twin_ms:.4f} ms, bound {nb[0]:.4f} ms ({nb[1]}, "
              f"{nbytes / 1e6:.1f} MB), {nb[0] / norm_ms:.1%} of bound", flush=True)
        rows = {ops.FRONT: dict(ms=front_ms, plain_ms=front_twin_ms, bound_ms=fb[0],
                                bound_by=fb[1], library_ms=None, values_apart=apart),
                ops.NORM: dict(ms=norm_ms, plain_ms=norm_twin_ms, bound_ms=nb[0],
                               bound_by=nb[1], library_ms=None, values_apart=norm_apart,
                               share_apart=norm_apart / out.numel(), most_ulps=norm_most)}
        for name, row in rows.items():
            if i == 0:  # phase 7's mamba2 prefill: the table's row
                results[name].update(row)
            else:
                results[name].setdefault("shapes", []).append(dict(row, case=shape))
        del proj, w, bias, dt_bias, tl, got, y, x_in, gate, out, d_skip, norm_w
        torch.cuda.empty_cache()
    return results


def _da_bound(case, fused: bool) -> tuple:
    """(bound_ms, bound_by): q and the live K / V rows read once, and the
    output (fused: [B, 1, H, D] in q's dtype) or the f32 partials (m, l, acc
    over ``default_num_splits`` for its form) written once; 4 * D operations per (query
    head, live key) at the inputs' type's peak rate."""
    import torch

    from repro_torch.kernels.decode_attention import kernel, ops, ref

    b, skv, h, kv, d, kv_len, window, _, dtype = case
    esize = 2 if dtype == "bfloat16" else 4
    live = kv_len if window is None else min(kv_len, window - 1)
    nbytes = esize * (b * h * d + 2 * b * kv * live * d)
    if fused:
        nbytes += esize * b * h * d
    else:
        route = kernel.partials_route(getattr(torch, dtype), d)
        ns = ref.split_count(skv, ops.default_num_splits(b * kv, skv, route))
        nbytes += 4 * b * kv * ns * (h // kv) * (2 + d)
    ops_ = 4.0 * d * b * h * live
    rate = BF16_OPS_PER_S if dtype == "bfloat16" else F32_OPS_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops_ / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _decode_softcap_check(case) -> dict:
    """The fused kernel and the partials kernel (in the form its route names
    and, on the tc form's inputs, the simt form) on inputs whose scores
    reach the cap, with and without the cap (uncounted launches): capped
    within the tolerance of the oracle (the partials of their twin),
    uncapped beyond it -> a row for the JSON line (the partials' forms
    under ``partials``)."""
    import torch

    from repro_torch.kernels.decode_attention import kernel, ops, ref

    b, skv, h, kv, d, kv_len, window, cap, dtype, q_scale = case
    dev, dt = torch.device("cuda"), getattr(torch, dtype)
    g = torch.Generator(device=dev).manual_seed(kv_len + d + 1)
    q = (torch.randn((b, 1, h, d), generator=g, device=dev) * q_scale).to(dt)
    k, v = (torch.randn((b, skv, kv, d), generator=g, device=dev).to(dt) for _ in range(2))
    kl = torch.full((1,), kv_len, dtype=torch.int32, device=dev)
    qm = q.reshape(b * kv, h // kv, d).contiguous()
    form = kernel.fused_route(dt, d)
    ns = ops.fused_num_splits(b * kv, skv, form)
    oracle = ref.reference_decode(q, k, v, kl, softcap=cap, window=window).float()
    tol, part_tol = (_binding_tol(t, dtype, q_scale) for t in (FA_TOL[dtype], DA_TOL))
    label = (f"B={b} H={h} KV={kv} D={d} kv_len={kv_len} window={window} softcap={cap} "
             f"{dtype} q_scale={q_scale} (fused: {form})")
    row = {"case": label, "q_scale": q_scale, "partials": {}}
    for name, c in (("capped", cap), ("no_softcap", None)):
        out = torch.empty_like(qm)
        kernel.launch_fused(qm, k, v, kl, out, num_splits=ns, softcap=c, window=window)
        torch.cuda.synchronize()
        got = out.reshape(b, 1, h, d).float()
        row[f"fused_{name}_err"] = (got - oracle).abs().max().item()
        row[f"fused_{name}_within_tol"] = torch.allclose(got, oracle, rtol=tol, atol=tol)
    route = kernel.partials_route(dt, d)
    nsp = ref.split_count(skv, ops.default_num_splits(b * kv, skv, route))
    km, vm = (t.transpose(1, 2).reshape(b * kv, skv, d).contiguous() for t in (k, v))
    want = ref.decode_attention_partials(qm, km, vm, kl, num_splits=nsp, softcap=cap,
                                         window=window)
    for pform in (route, "simt") if route == "tc" else (route,):
        prow = row["partials"][pform] = {}
        for name, c in (("capped", cap), ("no_softcap", None)):
            m, l, acc = (torch.empty(t.shape, device=dev) for t in want)  # contiguous
            kernel.launch(qm, k, v, kl, m, l, acc, softcap=c, window=window, form=pform)
            torch.cuda.synchronize()
            prow[f"{name}_err"] = max((x - y).abs().max().item()
                                      for x, y in zip((m, l, acc), want))
            prow[f"{name}_within_tol"] = all(
                torch.allclose(x, y, rtol=part_tol, atol=part_tol)
                for x, y in zip((m, l, acc), want))
    parts = "; ".join(f"partials {f} capped {p['capped_err']:.3g}, without the cap "
                      f"{p['no_softcap_err']:.3g} from the twin"
                      for f, p in row["partials"].items())
    print(f"[decode] softcap where it binds, {label}: fused capped {row['fused_capped_err']:.3g}, "
          f"without the cap {row['fused_no_softcap_err']:.3g} from the oracle (tol {tol}); "
          f"{parts} (tol {part_tol:.3g})", flush=True)
    assert row["fused_capped_within_tol"], row
    assert not row["fused_no_softcap_within_tol"], f"the cap does not bind: {row}"
    for p in row["partials"].values():
        assert p["capped_within_tol"], row
        assert not p["no_softcap_within_tol"], f"the cap does not bind: {row}"
    return row


def _decode_simt_ms(q, k, v, kl, oracle, kw, label) -> float:
    """The fused kernel's simt form on inputs its tc form serves (bf16 at D
    80 / 256, which the simt form took before), uncounted: held within the
    bf16 tolerance of the oracle, then timed -> ms."""
    import torch

    from repro_torch.kernels.decode_attention import kernel, ops

    b, _, h, d = q.shape
    kv = k.shape[2]
    qm = q.reshape(b * kv, h // kv, d)
    out = torch.empty_like(qm)
    ns = ops.fused_num_splits(b * kv, k.shape[1], "simt")

    def call():
        kernel.launch_fused(qm, k, v, kl, out, num_splits=ns, form="simt", **kw)

    call()
    torch.cuda.synchronize()
    tol = FA_TOL["bfloat16"]
    err = (out.reshape(q.shape).float() - oracle.float()).abs().max().item()
    assert err <= tol, f"the simt form at {label} is {err} from the oracle (tol {tol})"
    ms = _time_ms(call)
    print(f"[decode] {label}: the simt form on the same inputs ({ns} splits) {ms:.4f} ms, "
          f"{err:.3g} from the oracle", flush=True)
    return ms


def phase_decode() -> tuple:
    """Kernel 5 at the qwen3-1.7b decode shape and the zoo's: the fused
    kernel (the model's route) against its twin and the oracle, the partials
    kernel (the mesh decode's route) in the form ``partials_route`` names
    against its twin, and on the tc form's inputs its simt form (uncounted)
    -> (partials simt results, partials tc results, fused results)."""
    import torch
    import torch.nn.functional as tnf

    from repro_torch.kernels.decode_attention import kernel, ops, ref

    dev = torch.device("cuda")
    part = {"simt": {"max_abs_err": 0.0}, "tc": {"max_abs_err": 0.0}}
    fused = {"max_abs_err": 0.0}
    for case in DA_CASES:
        b, skv, h, kv, d, kv_len, window, cap, dtype = case
        dt = getattr(torch, dtype)
        g = torch.Generator(device=dev).manual_seed(kv_len + d)
        q = torch.randn((b, 1, h, d), generator=g, device=dev).to(dt)
        k, v = (torch.randn((b, skv, kv, d), generator=g, device=dev).to(dt) for _ in range(2))
        kl = torch.full((1,), kv_len, dtype=torch.int32, device=dev)
        form = kernel.partials_route(dt, d)
        ns = ref.split_count(skv, ops.default_num_splits(b * kv, skv, form))  # as the wrapper
        fns = ops.fused_num_splits(b * kv, skv, kernel.fused_route(dt, d))
        qm = q.reshape(b * kv, h // kv, d)
        km, vm = (t.transpose(1, 2).reshape(b * kv, skv, d).contiguous() for t in (k, v))
        kw = dict(softcap=cap, window=window)
        # the partials kernel takes every group here (G 6 / 7 at D 128 too); its
        # route's form, and on the tc form's inputs the simt form at its own
        # split count (the route's before the tc form), uncounted
        ns_simt = ref.split_count(skv, ops.default_num_splits(b * kv, skv, "simt"))
        simt_out = [torch.empty((b * kv, ns_simt, h // kv), device=dev) for _ in range(2)]
        simt_out.append(torch.empty((b * kv, ns_simt, h // kv, d), device=dev))

        def partials_call():
            return ops.cache_partials(qm, k, v, kl, ns, **kw)

        def partials_simt():
            kernel.launch(qm, k, v, kl, *simt_out, form="simt", **kw)
            return simt_out

        def partials_plain():
            return ref.decode_attention_partials(qm, km, vm, kl, num_splits=ns, **kw)

        def fused_call():
            return ops.decode_attention(q, k, v, kl, **kw)

        def fused_plain():
            return ref.decode_attention_fused(q, k, v, kl, num_splits=fns, **kw)

        before, forms = dict(ops.LAUNCHES), dict(ops.PARTIAL_ROUTES)
        got, want = partials_call(), partials_plain()
        out, twin = fused_call(), fused_plain()
        oracle = ref.reference_decode(q, k, v, kl, **kw)
        torch.cuda.synchronize()
        assert ops.LAUNCHES == {ops.KERNEL: before[ops.KERNEL] + 1,
                                ops.FUSED: before[ops.FUSED] + 1}, ops.LAUNCHES
        assert ops.PARTIAL_ROUTES == {**forms, form: forms[form] + 1}, ops.PARTIAL_ROUTES
        held = {form: (got, want)}
        if form == "tc":
            held["simt"] = ([t.clone() for t in partials_simt()], want if ns_simt == ns else
                            ref.decode_attention_partials(qm, km, vm, kl, num_splits=ns_simt, **kw))
            torch.cuda.synchronize()
        for f, (got_f, want_f) in held.items():
            for name, x, y in zip(("m", "l", "acc"), got_f, want_f):
                if not torch.allclose(x, y, rtol=DA_TOL, atol=DA_TOL):
                    raise AssertionError(f"decode_attention_partials ({f}) {case}: {name} "
                                         f"differs from the plain twin by "
                                         f"{(x - y).abs().max().item()} (tol {DA_TOL})")
                part[f]["max_abs_err"] = max(part[f]["max_abs_err"], (x - y).abs().max().item())
        tol = FA_TOL[dtype]
        err = (out.float() - oracle.float()).abs().max().item()
        twin_err = (out.float() - twin.float()).abs().max().item()
        assert torch.allclose(out.float(), oracle.float(), rtol=tol, atol=tol), (case, err)
        if dtype == "float32":  # the same splits and f32 sums in another order
            assert torch.allclose(out, twin, rtol=DA_TOL, atol=DA_TOL), (case, twin_err)
        fused["max_abs_err"] = max(fused["max_abs_err"], twin_err)
        label = (f"B={b} H={h} KV={kv} D={d} kv_len={kv_len} of {skv} window={window} "
                 f"softcap={cap} {dtype} (fused: {kernel.fused_route(dt, d)}, partials: {form})")
        if window is not None and case not in ZOO_DA:
            print(f"[decode] {label}: partials ({ns} splits, {', '.join(held)}) within {DA_TOL} "
                  f"of the twin; fused ({fns} splits) within {twin_err:.3g} of its twin, "
                  f"{err:.3g} of the oracle (tol {tol})", flush=True)
            continue
        if cap is None:  # sdpa over the live keys, GQA
            qt = q.transpose(1, 2)
            kt, vt = (t[:, :kv_len].transpose(1, 2) for t in (k, v))
            mask = None
            if window is not None:  # the kernel's window: keys > kv_len - window
                mask = (torch.arange(kv_len, device=dev) > kv_len - window)[None, :]

            def library_call():
                return tnf.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                        enable_gqa=True)
            lib_name = "sdpa"
        else:  # SDPA does not softcap; the query sits at kv_len - 1
            library_call = _flex_call(q, k[:, :kv_len], v[:, :kv_len], causal=False,
                                      window=None if window is None else window - 1, cap=cap,
                                      q_base=kv_len - 1)
            lib_name = "flex_attention"
        lib = library_call().transpose(1, 2)
        torch.cuda.synchronize()
        assert torch.allclose(lib.float(), oracle.float(), rtol=tol, atol=tol), (
            f"{lib_name} disagrees at {label}")
        timed = [fused_call, fused_plain, library_call, partials_call, partials_plain]
        if form == "tc":
            timed.append(partials_simt)
        ms, plain_ms, library_ms, p_ms, p_plain_ms, *simt_ms = (_time_ms(f) for f in timed)
        host_ms = _host_ms(fused_call)
        bound_ms, bound_by = _da_bound(case, fused=True)
        p_bound_ms, p_bound_by = _da_bound(case, fused=False)
        combine_ms = _time_ms(lambda: ref.combine_partials(*partials_call()))
        sdpa = f"{lib_name} {library_ms:.4f} ms"
        row = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                   library_ms=library_ms, host_ms=host_ms)
        p_row = dict(ms=p_ms, plain_ms=p_plain_ms, bound_ms=p_bound_ms, bound_by=p_bound_by,
                     library_ms=library_ms, with_combine_ms=combine_ms, splits=ns)
        if simt_ms:
            p_row.update(simt_ms=simt_ms[0], simt_splits=ns_simt)
        partials = (f"partials {form} ({ns} splits) {p_ms:.4f} ms (with the PyTorch combine "
                    f"{combine_ms:.4f} ms), plain {p_plain_ms:.4f} ms, bound {p_bound_ms:.4f} "
                    f"ms ({p_bound_by}), {p_bound_ms / p_ms:.1%} of bound"
                    + (f"; the simt form on the same inputs ({ns_simt} splits) {simt_ms[0]:.4f} ms"
                       if simt_ms else ""))
        print(f"[decode] {label}: fused ({fns} splits, one launch) {ms:.4f} ms ({host_ms:.4f} "
              f"ms a call issued one after another from the host), within {twin_err:.3g} of "
              f"its twin and {err:.3g} of the oracle, plain {plain_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}), {bound_ms / ms:.1%} of bound; {partials}; "
              f"{sdpa}", flush=True)
        if case == DA_ROW:  # the qwen3 decode in the model's dtype: the table's rows
            fused.update(row)
            part["tc"].update(p_row)
            part["simt"].update(p_row, ms=simt_ms[0], tc_ms=p_ms, splits=ns_simt)
        elif case in ZOO_DA:
            shape = dict(row, case=label, serves=ZOO_DA[case], library=lib_name)
            if kernel.fused_route(dt, d) == "tc" and d not in (64, 128):
                shape["simt_ms"] = _decode_simt_ms(q, k, v, kl, oracle, kw, label)
                assert ms < shape["simt_ms"], (
                    f"the fused kernel's tc form ({ms:.4f} ms) is slower than its simt form "
                    f"({shape['simt_ms']:.4f} ms) at {label}")
            fused.setdefault("shapes", []).append(shape)
            part[form].setdefault("shapes", []).append(
                dict(p_row, case=label, serves=ZOO_DA[case], library=lib_name))
    fused["softcap"] = [_decode_softcap_check(case) for case in DA_BINDING]
    for f in ("tc", "simt"):
        part[f]["softcap"] = [dict(r["partials"][f], case=r["case"], q_scale=r["q_scale"])
                              for r in fused["softcap"] if f in r["partials"]]
    return part["simt"], part["tc"], fused


def _generate(model, params, tokens, steps, max_len, extra=None):
    """Prefill (with the batch's ``extra`` inputs: image embeds, frames) then
    ``steps`` greedy decode steps -> (logits per step, tokens, cache)."""
    logits, cache = model.prefill(params, {"tokens": tokens, **(extra or {})}, max_len)
    out, chosen = [logits], []
    for _ in range(steps):
        tok = logits.argmax(-1)
        chosen.append(tok)
        logits, cache = model.decode_step(params, tok, cache)
        out.append(logits)
    return out, chosen, cache


def phase_serve_cpu_vs_gpu():
    """Reduced f32 qwen3 and mamba2 models: prefill + 8 greedy decode steps on
    the CPU (plain twins) and the card (kernels), the same weights."""
    import dataclasses

    import torch

    from repro_torch.configs.archs import get_config
    from repro_torch.enrich.cascade import map_tree
    from repro_torch.models.model import random_model

    torch.backends.cuda.matmul.allow_tf32 = False
    for arch in ("qwen3-1.7b", "mamba2-370m"):
        cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
        model, params = random_model(cfg, seed=3, device="cpu")
        g = torch.Generator().manual_seed(4)
        tokens = torch.randint(0, cfg.vocab_size, (4, 96), generator=g)
        cpu = _generate(model, params, tokens, 8, 128)
        gpu = _generate(model, map_tree(lambda t: t.to("cuda"), params), tokens.cuda(), 8, 128)
        worst = 0.0
        for i, (a, b) in enumerate(zip(cpu[0], gpu[0])):
            err = (a - b.cpu()).abs().max().item()
            assert err <= SERVE_LOGIT_TOL, f"{arch} step {i}: logits differ by {err}"
            worst = max(worst, err)
        for i, (a, b) in enumerate(zip(cpu[1], gpu[1])):
            assert torch.equal(a, b.cpu()), f"{arch} step {i}: greedy tokens differ"
        assert int(cpu[2].length) == int(gpu[2].length) == 104
        print(f"[serve-cpu-gpu] reduced f32 {arch}: prefill 96 tokens x 4 + 8 greedy steps, "
              f"logits within {worst:.3g} (<= {SERVE_LOGIT_TOL}), greedy tokens equal", flush=True)


def _launches(fa_ops, da_ops, ssd_ops, mixer_ops) -> dict:
    """The kernel counters (the mixer's two kernels among them), the flash and
    SSD launches split by route, the fused and partials decode launches by
    form."""
    return {**fa_ops.LAUNCHES, **da_ops.LAUNCHES, **ssd_ops.LAUNCHES, **mixer_ops.LAUNCHES,
            **{f"flash_attention/{r}": n for r, n in fa_ops.ROUTES.items()},
            **{f"decode_attention_fused/{r}": n for r, n in da_ops.ROUTES.items()},
            **{f"decode_attention_partials/{r}": n for r, n in da_ops.PARTIAL_ROUTES.items()},
            **{f"ssd_intra_chunk/{r}": n for r, n in ssd_ops.ROUTES.items()}}


def _extra_inputs(cfg, b, gen) -> dict:
    """A batch's frames (an encoder's input) on the CPU, from ``gen``."""
    import torch

    if cfg.encoder is None:
        return {}
    return {"frames": torch.randn((b, cfg.encoder.seq_len, cfg.d_model), generator=gen)}


def phase_serve_bf16_cpu_vs_gpu():
    """Reduced bf16 models whose widths route the card's bf16 kernels — qwen3
    (head_dim 128, GQA 2 / 1), mamba2 (SSM head_dim 64, state 128, chunk
    256), gemma2 (head_dim 256, local / global, both softcaps), h2o-danube
    (head_dim 80), hymba (GQA 5 / 1 beside SSD heads of state 16) and
    seamless (an encoder over 128 frames, cross-attention): the CPU (plain
    twins) greedy-decodes, and the card (kernels) and an f32 CPU run of the
    same weights are fed the CPU's tokens (teacher-forced, so no bf16
    near-tie can fork the sequences).  The card must stay within
    ``BF16_LOGIT_FACTOR`` times the bf16 CPU run's own distance from f32:
    the kernels may add no more error than bf16 rounding already makes."""
    import dataclasses

    import torch

    from repro_torch.configs.archs import get_config
    from repro_torch.enrich.cascade import map_tree
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssm_mixer import ops as mixer_ops
    from repro_torch.models.model import random_model, teacher_forced

    torch.backends.cuda.matmul.allow_tf32 = False
    counted = (fa_ops, da_ops, ssd_ops, mixer_ops)
    for arch, (prompt, steps, b) in BF16_CHECK.items():
        cfg = get_config(arch, bf16_check=True)
        model, params = random_model(cfg, seed=5, device="cpu")
        g = torch.Generator().manual_seed(6)
        tokens = torch.randint(0, cfg.vocab_size, (b, prompt), generator=g)
        extra = _extra_inputs(cfg, b, g)
        max_len = prompt + steps + 8
        cpu, chosen, _ = _generate(model, params, tokens, steps, max_len, extra)
        seq = torch.cat([tokens, *chosen], dim=1)
        f32_model, f32_params = (random_model(dataclasses.replace(cfg, dtype="float32"),
                                              seed=5, device="cpu")[0],
                                 map_tree(lambda t: t.float(), params))
        ref, _ = teacher_forced(f32_model, f32_params, seq, prompt, max_len, extra)
        for c in counted:
            c.reset_counts()
        gpu, cache = teacher_forced(model, map_tree(lambda t: t.to("cuda"), params), seq.cuda(),
                                    prompt, max_len, {k: v.cuda() for k, v in extra.items()})
        torch.cuda.synchronize()
        launches = _launches(fa_ops, da_ops, ssd_ops, mixer_ops)
        plain = {**fa_ops.PLAIN_CALLS, **da_ops.PLAIN_CALLS, **ssd_ops.PLAIN_CALLS,
                 **mixer_ops.PLAIN_CALLS}
        want = _zoo_expected(cfg, steps)
        assert {k: launches.get(k, 0) for k in want} == want, (arch, launches, want)
        assert not any(plain.values()), f"plain path ran on the card: {plain}"
        assert int(cache.length) == prompt + steps
        gpu = [x.cpu() for x in gpu]
        assert all(torch.isfinite(x).all() for x in gpu)
        bf16_err = max((a - r).abs().max().item() for a, r in zip(cpu, ref))
        gpu_f32 = max((a - r).abs().max().item() for a, r in zip(gpu, ref))
        err = max((a - c).abs().max().item() for a, c in zip(gpu, cpu))
        scale = max(r.abs().max().item() for r in ref)
        per_step = [round((a - c).abs().max().item(), 5) for a, c in zip(gpu, cpu)]
        tol = BF16_LOGIT_FACTOR * bf16_err
        assert err <= tol, (f"{arch} bf16: card vs CPU logits differ by {err} > {tol} "
                            f"({BF16_LOGIT_FACTOR} x the CPU's bf16-vs-f32 {bf16_err}); per step "
                            f"{per_step}")
        print(f"[serve-bf16] reduced bf16 {arch} ({cfg.num_layers} layers, d_model "
              f"{cfg.d_model}, D {cfg.head_dim}): prefill {prompt} x {b} + {steps} "
              f"teacher-forced steps; card vs CPU logits max abs {err:.4g} (tol {tol:.4g} = "
              f"{BF16_LOGIT_FACTOR} x the CPU bf16 run's distance from f32 {bf16_err:.4g}; card "
              f"vs f32 {gpu_f32:.4g}; logit scale {scale:.3g}); per step {per_step}; launches "
              f"{launches}", flush=True)


def phase_moe_cpu_vs_gpu():
    """The MoE smoke models (grok-1: 4 experts, geglu; Arctic: 8 experts with
    the dense residual), prefill + greedy decode on the CPU and the card from
    the same weights, teacher-forced on the CPU's tokens: in f32 the router's
    choices must be equal on every layer and step and the logits within
    ``MOE_LOGIT_TOL``; in bf16 the choices that flip (bf16 matmuls round
    the router logits differently on the two devices) are only printed."""
    import dataclasses

    import torch

    from repro_torch.configs.archs import get_config
    from repro_torch.enrich.cascade import map_tree
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models.model import random_model, teacher_forced
    from repro_torch.models.moe import recording_routes

    torch.backends.cuda.matmul.allow_tf32 = False
    for arch, (prompt, steps, b) in MOE_CHECK.items():
        flips = {}
        for dtype in ("float32", "bfloat16"):
            cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=dtype)
            model, params = random_model(cfg, seed=9, device="cpu")
            g = torch.Generator().manual_seed(10)
            tokens = torch.randint(0, cfg.vocab_size, (b, prompt), generator=g)
            max_len = prompt + steps + 8
            runs = []
            for dev in ("cpu", "cuda"):
                with recording_routes() as seen:
                    if dev == "cpu":
                        out, chosen, _ = _generate(model, params, tokens, steps, max_len)
                        seq = torch.cat([tokens, *chosen], dim=1)
                    else:
                        fa_ops.reset_counts()
                        da_ops.reset_counts()
                        out, _ = teacher_forced(model, map_tree(lambda t: t.to(dev), params),
                                                seq.to(dev), prompt, max_len)
                        torch.cuda.synchronize()
                        assert not fa_ops.PLAIN_CALLS["flash_attention"] and not any(
                            da_ops.PLAIN_CALLS.values()), "plain path ran on the card"
                        # head_dim 16: the simt flash kernel in the prefill
                        assert fa_ops.ROUTES["simt"] == cfg.num_layers, fa_ops.ROUTES
                runs.append(([o.cpu() for o in out], seen))
            (cpu, cpu_routes), (gpu, gpu_routes) = runs
            assert len(cpu_routes) == len(gpu_routes) == cfg.num_layers * (steps + 1)
            flipped = sum(int((a != c).any(-1).sum()) for a, c in zip(cpu_routes, gpu_routes))
            tokens_routed = sum(a.shape[0] * a.shape[1] for a in cpu_routes)
            err = max((a - c).abs().max().item() for a, c in zip(gpu, cpu))
            if dtype == "float32":
                assert flipped == 0, f"{arch} f32: {flipped} router choices differ CPU vs card"
                assert err <= MOE_LOGIT_TOL, f"{arch} f32: logits differ by {err}"
            flips[dtype] = (flipped, tokens_routed, err)
        print(f"[moe-cpu-gpu] {arch} smoke ({cfg.num_layers} layers, {cfg.moe.num_experts} "
              f"experts top-{cfg.moe.top_k}): prefill {prompt} x {b} + {steps} teacher-forced "
              f"steps; f32: router choices equal ({flips['float32'][1]} tokens x layers), "
              f"logits within {flips['float32'][2]:.3g} (<= {MOE_LOGIT_TOL}); bf16: "
              f"{flips['bfloat16'][0]} of {flips['bfloat16'][1]} choices flip, logits within "
              f"{flips['bfloat16'][2]:.3g}", flush=True)


def phase_cascade_bf16_cpu_vs_gpu():
    """The cascade bank with the reduced bf16 qwen3 trunk, built on the CPU
    and copied to the card; ``execute`` over the same merged plans (every
    (pred, level), the trunk on each) on the CPU (plain twins), on the card
    (kernels: every trunk attention by the "short" route) and on the CPU with
    an f32 trunk of the same weights.  The card must stay within
    ``BF16_LOGIT_FACTOR`` times the bf16 CPU run's own distance from f32."""
    import numpy as np
    import torch

    from repro_torch.configs.archs import get_config
    from repro_torch.core.plan import Plan
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import serve

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    n, npred, lanes, count = CASCADE_BF16
    cfg = get_config("qwen3-1.7b", bf16_check=True)
    _, _, bank, _, _, _ = serve._offline_phase(n, npred, cfg, seed=0, train_size=128,
                                               device="cpu")
    f32_bank, gpu_bank = bank.to("cpu", dtype="float32"), bank.to("cuda")
    rng = np.random.default_rng(8)
    plans = []
    for _ in range(count):
        idx = [torch.from_numpy(rng.integers(0, hi, lanes))
               for hi in (n, npred, bank.num_levels)]
        zero = torch.zeros(lanes)
        plans.append(Plan(*idx, zero, zero, torch.from_numpy(rng.uniform(size=lanes) < 0.9)))
    fa_ops.reset_counts()
    gpu = [gpu_bank.execute(pl.map(lambda t: t.to("cuda"))).cpu() for pl in plans]
    torch.cuda.synchronize()
    routes = dict(fa_ops.ROUTES)
    assert routes == {"tc": 0, "short": cfg.num_layers * count, "split": 0, "simt": 0}, routes
    assert not fa_ops.PLAIN_CALLS["flash_attention"], fa_ops.PLAIN_CALLS
    cpu = [bank.execute(pl) for pl in plans]
    ref = [f32_bank.execute(pl) for pl in plans]
    bf16_err = max((c - r).abs().max().item() for c, r in zip(cpu, ref))
    err = max((g - c).abs().max().item() for g, c in zip(gpu, cpu))
    gpu_f32 = max((g - r).abs().max().item() for g, r in zip(gpu, ref))
    tol = BF16_LOGIT_FACTOR * bf16_err
    assert all(torch.isfinite(g).all() and ((g >= 0) & (g <= 1)).all() for g in gpu)
    assert 0.0 < bf16_err and err <= tol, (
        f"bf16 cascade: card vs CPU probabilities differ by {err} > {tol} "
        f"({BF16_LOGIT_FACTOR} x the CPU's bf16-vs-f32 {bf16_err})")
    print(f"[cascade-bf16] reduced bf16 qwen3 trunk ({cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.num_heads} / {cfg.num_kv_heads} heads, D {cfg.head_dim}), "
          f"{count} merged plans of {lanes} lanes: card vs CPU probabilities max abs {err:.4g} "
          f"(tol {tol:.4g} = {BF16_LOGIT_FACTOR} x the CPU bf16 run's distance from f32 "
          f"{bf16_err:.4g}; card vs f32 {gpu_f32:.4g}); flash routes {routes}; in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def phase_model_serve() -> dict:
    """``Model.prefill`` + ``decode_step`` at full width: qwen3-1.7b (the "tc"
    flash kernel in prefill, the fused decode kernel per step) and
    mamba2-370m (the "tc" SSD kernel in prefill, ``ssd_step`` per decode
    step)."""
    import torch

    from repro_torch.configs.archs import get_config
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssm_mixer import ops as mixer_ops

    from repro_torch.models.model import random_model

    counted = (fa_ops, da_ops, ssd_ops, mixer_ops)
    launches = {}
    for arch, b, prompt, steps, max_len in SERVE_PATHS:
        cfg = get_config(arch)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model, params = random_model(cfg, seed=0, device="cuda")
        g = torch.Generator(device="cuda").manual_seed(1)
        tokens = torch.randint(0, cfg.vocab_size, (b, prompt), generator=g, device="cuda")
        _generate(model, params, tokens[:, :256], 2, 512)  # warm-up (cuBLAS, allocator)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        for c in counted:
            c.reset_counts()
        t1 = time.perf_counter()
        logits, cache = model.prefill(params, {"tokens": tokens}, max_len)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t1
        run = _launches(fa_ops, da_ops, ssd_ops, mixer_ops)
        routes = dict(fa_ops.ROUTES)
        step_s = []
        for _ in range(steps):
            t2 = time.perf_counter()
            logits, cache = model.decode_step(params, logits.argmax(-1), cache)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t2)
        run_all = _launches(fa_ops, da_ops, ssd_ops, mixer_ops)
        plain = {**fa_ops.PLAIN_CALLS, **da_ops.PLAIN_CALLS, **ssd_ops.PLAIN_CALLS,
                 **mixer_ops.PLAIN_CALLS}
        peak = torch.cuda.max_memory_allocated()
        n = cfg.num_layers
        idle = {"decode_attention_partials": 0, "decode_attention_fused": 0,
                "decode_attention_fused/tc": 0, "decode_attention_fused/simt": 0,
                "decode_attention_fused/split": 0, "decode_attention_partials/tc": 0, "decode_attention_partials/simt": 0,
                "ssd_intra_chunk": 0, "flash_attention": 0, "flash_attention/simt": 0,
                "flash_attention/tc": 0, "flash_attention/short": 0, "flash_attention/split": 0,
                "ssd_intra_chunk/tc": 0, "ssd_intra_chunk/simt": 0,
                "ssd_intra_chunk/packed": 0, "ssd_inter_chunk": 0,
                **dict.fromkeys(MIXER_KERNELS, 0)}
        if arch == "qwen3-1.7b":
            # the prefill on the tensor cores; one fused decode launch a layer and step
            assert run == {**idle, "flash_attention": n, "flash_attention/tc": n}, run
            assert routes == {"tc": n, "short": 0, "split": 0, "simt": 0}, routes
            assert run_all == {**run, "decode_attention_fused": n * steps,
                               "decode_attention_fused/tc": n * steps}, run_all
        else:
            # each layer's prefill: the mixer's front, the intra-chunk kernel, the
            # recurrence from the cache's state, the gated norm
            assert run == {**idle, "ssd_intra_chunk": n, "ssd_intra_chunk/tc": n,
                           "ssd_inter_chunk": n, **dict.fromkeys(MIXER_KERNELS, n)}, run
            # a decode step: the mixer's two kernels a layer around ssd_step
            assert run_all == {**run, **dict.fromkeys(MIXER_KERNELS, n * (1 + steps))}, run_all
        assert not any(plain.values()), f"plain path ran on the {arch} serve path: {plain}"
        assert logits.shape == (b, 1, cfg.vocab_size) and torch.isfinite(logits).all()
        assert int(cache.length) == prompt + steps
        for k, v in run_all.items():
            launches[k] = launches.get(k, 0) + v
        print(f"[serve-model] {arch} at full width ({n} layers, d_model {cfg.d_model}, bf16): "
              f"setup {setup_s:.2f} s; prefill B={b} x {prompt} tokens {prefill_s * 1e3:.2f} ms "
              f"({b * prompt / prefill_s:.0f} tokens/s, flash routes {routes}); {steps} decode "
              f"steps {statistics.median(step_s) * 1e3:.3f} ms median per step ({min(step_s) * 1e3:.3f}"
              f"-{max(step_s) * 1e3:.3f}; host clock, "
              f"synchronised per step); launches {run_all}; peak device memory "
              f"{peak / 2**30:.3f} GiB", flush=True)
        del params, cache, logits
        torch.cuda.empty_cache()
    return launches


def _zoo_expected(cfg, steps: int) -> dict:
    """The launches a bf16 run of ``cfg`` (prefill + ``steps`` decode steps)
    must make: {counter: count}."""
    n = cfg.num_layers
    want = dict.fromkeys(("flash_attention/tc", "flash_attention/short", "flash_attention/split",
                          "flash_attention/simt", "decode_attention_partials",
                          "decode_attention_partials/tc", "decode_attention_partials/simt",
                          "decode_attention_fused", "decode_attention_fused/tc",
                          "decode_attention_fused/simt", "decode_attention_fused/split",
                          "ssd_intra_chunk/tc",
                          "ssd_intra_chunk/simt", "ssd_intra_chunk/packed"), 0)
    if cfg.layer_pattern == ("mamba",):  # SSD heads of state 128 alone: the tc route
        want["ssd_intra_chunk/tc"] = n  # (a decode step runs ssd_step: no kernel)
    else:  # the prefill on "tc" at every zoo head dim (64, 80, 128, 256), then
        # one fused decode launch a layer and step, on the tc form at each of them
        flash = "flash_attention/tc"
        want[flash] = n
        want["decode_attention_fused"] = want["decode_attention_fused/tc"] = n * steps
    if cfg.encoder is not None:  # the encoder's layers, then a cross-attention a layer
        want[flash] += cfg.encoder.num_layers + n
        want["flash_attention/split"] = n * steps  # a decode step's cross-attention, Sq 1
    if "hymba" in cfg.layer_pattern:  # SSD heads of state 16: the tc route
        want["ssd_intra_chunk/tc"] = n
    want["flash_attention"] = sum(want[f"flash_attention/{r}"]
                                  for r in ("tc", "short", "split", "simt"))
    want["ssd_intra_chunk"] = sum(want[f"ssd_intra_chunk/{r}"] for r in ("tc", "simt", "packed"))
    want["ssd_inter_chunk"] = want["ssd_intra_chunk"]  # a prefill's recurrence from the cache
    ssm_layers = n if set(cfg.layer_pattern) & {"mamba", "hymba"} else 0
    for key in MIXER_KERNELS:  # the mixer's front and gated norm, prefill and every step
        want[key] = ssm_layers * (1 + steps)
    return want


def phase_zoo_serve() -> dict:
    """Phase 7b: the model zoo at published widths (random bf16 weights built
    on the card, one f32 matrix at a time): each of ``ZOO_ARCHS`` prefills
    its prompt (after llava's 2,880 image embeds; over seamless's 1,024
    frames), then decodes 16 greedy steps, then frees its memory.  Finite
    logits, the routes (every prefill on "tc"), the expected
    launches and no plain call; prefill ms (tokens/s), median step ms and
    peak memory are printed."""
    import gc

    import torch

    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssm_mixer import ops as mixer_ops
    from repro_torch.launch.profile import MODEL_SHAPES, model_batch, model_config
    from repro_torch.models.model import random_model

    counted = (fa_ops, da_ops, ssd_ops, mixer_ops)
    launches = {}
    t_phase = time.perf_counter()
    steps = ZOO_STEPS
    for arch in ZOO_ARCHS:
        cfg = model_config(arch)
        b, prompt = MODEL_SHAPES[arch]
        gc.collect()  # the earlier phases' sessions and banks, before a 55 GB build
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model, params = random_model(cfg, seed=0, device="cuda")
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        weights = sum(t.numel() * t.element_size() for t in _leaves(params))
        batch = model_batch(cfg, b, prompt, torch.Generator(device="cuda").manual_seed(1))
        extra = {k: v for k, v in batch.items() if k != "tokens"}
        n_img = cfg.num_image_tokens if "image_embeds" in batch else 0
        max_len = n_img + prompt + 32
        _generate(model, params, batch["tokens"], 2, max_len, extra)  # warm-up (cuBLAS)
        torch.cuda.synchronize()
        for c in counted:
            c.reset_counts()
        t1 = time.perf_counter()
        logits, cache = model.prefill(params, batch, max_len)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t1
        routes = dict(fa_ops.ROUTES)
        finite = bool(torch.isfinite(logits).all())
        step_s = []
        for _ in range(steps):
            t2 = time.perf_counter()
            logits, cache = model.decode_step(params, logits.argmax(-1), cache)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t2)
            finite = finite and bool(torch.isfinite(logits).all())
        run = _launches(fa_ops, da_ops, ssd_ops, mixer_ops)
        plain = {**fa_ops.PLAIN_CALLS, **da_ops.PLAIN_CALLS, **ssd_ops.PLAIN_CALLS,
                 **mixer_ops.PLAIN_CALLS}
        peak = torch.cuda.max_memory_allocated()
        want = _zoo_expected(cfg, steps)
        assert {k: run.get(k, 0) for k in want} == want, (arch, run, want)
        assert not any(plain.values()), f"plain path ran on the {arch} serve path: {plain}"
        assert finite and logits.shape == (b, 1, cfg.vocab_size), arch
        assert int(cache.length) == n_img + prompt + steps
        for k, v in run.items():
            launches[k] = launches.get(k, 0) + v
        seq = b * (n_img + prompt)
        inputs = f"{n_img} image embeds + {prompt} tokens" if n_img else (
            f"{prompt} tokens over {cfg.encoder.seq_len} frames" if cfg.encoder else
            f"{prompt} tokens")
        print(f"[zoo] {arch} at full width ({cfg.num_layers} layers, d_model {cfg.d_model}, "
              f"{cfg.num_heads}/{cfg.num_kv_heads} heads of D {cfg.head_dim}, bf16, "
              f"{weights / 1e9:.2f} GB of weights built in {build_s:.2f} s): prefill B={b} x "
              f"{inputs} {prefill_s * 1e3:.2f} ms ({seq / prefill_s:.0f} tokens/s, flash routes "
              f"{routes}); {steps} decode steps {statistics.median(step_s) * 1e3:.3f} ms "
              f"median per step ({min(step_s) * 1e3:.3f}-{max(step_s) * 1e3:.3f}; host clock, "
              f"synchronised per step); launches {run}; peak device memory "
              f"{peak / 2**30:.3f} GiB", flush=True)
        del model, params, batch, extra, logits, cache
    torch.cuda.empty_cache()
    print(f"[zoo] {len(ZOO_ARCHS)} architectures served in {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return launches


# ------------------------------------------------- phase 9b: the long cells --

# The reference's serve cells on one card (launch/cells.py SERVE_CELLS, each at
# one_card_cell's batch and depth).  Prefills: 1 untimed (one row) + CELL_PREFILLS
# timed; decodes: 1 untimed + CELL_STEPS timed steps, each from the cache at
# seq_len - 1.
CELL_PREFILLS = 3
CELL_STEPS = 5
CELL_GATE_TOL = {"qwen3-1.7b": 2e-2, "mamba2-370m": 2e-2}  # the bf16 serve gates (phase 8)
ZOO_GATE_TOL = 4e-2  # the zoo trunk's bf16 tolerance (hymba, danube, gemma2)
ROPE_TOL = 2e-5  # apply_rope, card vs CPU, f32: of the input's largest magnitude
ROPE_CASES = ((64, 1e4), (80, 1e4), (128, 1e6), (256, 1e4))
ROPE_POSITIONS = (0, 4095, 32767, 524287)
# kernel 5 at the long cells' decode shapes: b, skv, h, kv, d, kv_len, window (the
# kernel's: the model's + 1), softcap, dtype, q_scale -> the cell it serves.  q is
# drawn unit-normal x q_scale (phase 2's DA_BINDING scales): scores ~N(0, q_scale^2)
# against the log of 524,288 keys' ~13, so a few keys carry each output at any
# length and its values stay ~N(0, 1): FA_TOL binds.
CELL_DA = {
    (16, 32768, 16, 8, 128, 32768, None, None, "bfloat16", 12.0): "qwen3-1.7b decode_32k (B 16)",
    (1, 524288, 25, 5, 64, 524288, None, None, "bfloat16", 12.0): "hymba-1.5b long_500k",
    (1, 524288, 16, 8, 256, 524288, None, 50.0, "bfloat16", 16.0):
        "gemma2-9b long_500k, a global layer (K and V 2^30 elements each)",
    (1, 524288, 16, 8, 256, 524288, 4097, 50.0, "bfloat16", 16.0):
        "gemma2-9b long_500k, a local layer (window 4,096 at the end of the 2^30-element slice)",
    (1, 524288, 32, 8, 80, 524288, 4097, None, "bfloat16", 12.0):
        "h2o-danube-1.8b long_500k (window 4,096 at position 524,287)",
}
CELL_FA_Q_SCALE = 12.0  # the flash case's q, as the decode cases'
# the planted control: the kernel over all but the last CONTROL_ROWS keys (one
# KV tile and more of every route) must miss the tolerance that it passes
CONTROL_ROWS = 256
FA_BLOCK = 256  # the flash twin's query block: scores [B H, 256, <= 32,768] f32
SSD_BLOCK = 2  # the SSD twin's batch rows at a time


def _plant_last_rows(q, k, v, lo: int, hi: int) -> None:
    """Rows planted among the last live keys, in place: for each batch row
    and query head r (of kv head j = r // G), row ``hi - 1 - r`` of kv head
    j takes a copy of the key in ``[lo, hi - H)`` that scores highest
    against r's query (``q`` [B, H, D]) and the value 2 + r / 16 in every
    column.  It ties with r's best key, so it carries a share of r's output
    like that key's: a kernel that misses the last rows (a skipped tile, an
    offset formed in 32 bits that wraps) moves the output far past the
    tolerance."""
    import torch

    b, h, _ = q.shape
    g = h // k.shape[2]
    rows = torch.arange(b, device=k.device)
    for r in range(h):
        scores = torch.einsum("bnd,bd->bn", k[:, lo:hi - h, r // g].float(), q[:, r].float())
        k[:, hi - 1 - r, r // g] = k[rows, lo + scores.argmax(-1), r // g]
        v[:, hi - 1 - r, r // g] = 2.0 + r / 16


def _cell_decode_case(case, label) -> tuple:
    """Kernel 5 at a long cell's shape: the model's route (``decode_route``:
    the split route from ``SPLIT_FROM`` keys a fused block) counted once,
    both routes on the same inputs against the oracle and their twins and
    timed, the planted control (each route over all but the last
    CONTROL_ROWS keys must miss the oracle), the library call beside ->
    (fused row, partials row)."""
    import torch
    import torch.nn.functional as tnf

    from repro_torch.kernels.decode_attention import ops, ref

    b, skv, h, kv, d, kv_len, window, cap, dtype, q_scale = case
    dev = torch.device("cuda")
    dt = getattr(torch, dtype)
    g = torch.Generator(device=dev).manual_seed(skv + d + h)
    q = (torch.randn((b, 1, h, d), generator=g, device=dev) * q_scale).to(dt)
    k, v = (torch.randn((b, skv, kv, d), generator=g, device=dev, dtype=dt) for _ in range(2))
    lo = 0 if window is None else kv_len - window + 1
    _plant_last_rows(q[:, 0], k, v, lo, kv_len)
    kl = torch.full((1,), kv_len, dtype=torch.int32, device=dev)
    kw = dict(softcap=cap, window=window)
    route = ops.decode_route(dt, d, b * kv, skv, window)
    fns = ops.fused_num_splits(b * kv, skv, "tc")
    pns = ref.split_count(skv, ops.default_num_splits(b * kv, skv, "tc"))

    def fused_call(kl=kl):
        return ops.decode_attention(q, k, v, kl, num_splits=fns, **kw)

    def partials_call(kl=kl):
        return ops.decode_attention_split(q, k, v, kl, **kw)

    def split_call(kl=kl):
        return ref.combine_partials(*partials_call(kl)).reshape(b, 1, h, d).to(dt)

    def fused_plain():
        return ref.decode_attention_fused(q, k, v, kl, num_splits=fns, **kw)

    def split_plain():
        qm = q.reshape(b * kv, h // kv, d)
        km, vm = (t.transpose(1, 2).reshape(b * kv, skv, d) for t in (k, v))
        return ref.decode_attention_partials(qm, km, vm, kl, num_splits=pns, **kw)

    before = dict(ops.ROUTES)
    out = ops.decode_attention(q, k, v, kl, **kw)  # the model's call
    torch.cuda.synchronize()
    key = "split" if route == "split" else "tc"
    assert ops.ROUTES == {**before, key: before[key] + 1}, (label, ops.ROUTES)
    assert torch.equal(out, fused_call() if route == "fused" else split_call()), label
    oracle = ref.reference_decode(q, k, v, kl, **kw).float()
    tol = FA_TOL[dtype]
    short = kl - CONTROL_ROWS
    errs, misses = {}, {}
    for name, call in (("fused", fused_call), ("split", split_call)):
        got = call().float()
        errs[name] = (got - oracle).abs().max().item()
        assert torch.allclose(got, oracle, rtol=tol, atol=tol), (
            f"{label}: the {name} route is {errs[name]} off the oracle")
        control = call(short).float()
        misses[name] = (control - oracle).abs().max().item()
        assert not torch.allclose(control, oracle, rtol=tol, atol=tol), (
            f"{label}: the {name} route without the last {CONTROL_ROWS} keys stays within "
            f"{misses[name]} of the oracle: the tolerance does not bind")
    if b * skv * kv * d >= 2**30:  # the index audit
        print(f"[cells] index audit ({label}): both routes read the planted rows "
              f"{kv_len - h}..{kv_len - 1} (within {max(errs.values()):.3g} of the oracle; "
              f"without the last {CONTROL_ROWS} keys {min(misses.values()):.3g} or more)",
              flush=True)
    twin = fused_plain().float()
    assert torch.allclose(fused_call().float(), twin, rtol=tol, atol=tol), (
        label, (fused_call().float() - twin).abs().max().item())
    for nm, x, y in zip(("m", "l", "acc"), partials_call(), split_plain()):
        x = x.reshape(y.shape)
        perr = (x - y).abs().max().item()
        assert perr <= DA_TOL * max(1.0, y.abs().max().item()), (label, nm, perr)
    if cap is None:  # SDPA over the live keys, GQA
        lo = 0 if window is None else kv_len - window + 1
        qt = q.transpose(1, 2)
        kt, vt = (t[:, lo:kv_len].transpose(1, 2) for t in (k, v))

        def library_call():
            return tnf.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True)
        lib_name = "sdpa"
    else:
        library_call = _flex_call(q, k[:, :kv_len], v[:, :kv_len], causal=False,
                                  window=None if window is None else window - 1, cap=cap,
                                  q_base=kv_len - 1)
        lib_name = "flex_attention"
    lib = library_call().transpose(1, 2).float()
    assert torch.allclose(lib, oracle, rtol=tol, atol=tol), (
        f"{lib_name} disagrees at {label} by {(lib - oracle).abs().max().item()}")
    ms = {n: _time_ms(f) for n, f in (("fused", fused_call), ("split", split_call),
                                      ("partials", partials_call), ("library", library_call))}
    plain_ms = _time_ms(fused_plain, reps=3, warmup=1, inner=1)
    bound_ms, bound_by = _da_bound(case[:9], fused=True)
    p_bound_ms, p_bound_by = _da_bound(case[:9], fused=False)
    served = ms[route]
    print(f"[cells] kernel 5 at {label}: B={b} H={h} KV={kv} D={d} kv_len={kv_len} window="
          f"{window} softcap={cap} q_scale={q_scale}; the route: {route}; fused ({fns} splits) "
          f"{ms['fused']:.4f} ms, split ({pns} splits + the combine) {ms['split']:.4f} ms (the "
          f"partials alone "
          f"{ms['partials']:.4f}), {lib_name} {ms['library']:.4f} ms, plain twin {plain_ms:.4f} "
          f"ms; bound {bound_ms:.4f} ms ({bound_by}): the route at {bound_ms / served:.1%} of "
          f"it; within {max(errs.values()):.3g} of the oracle (rtol = atol = {tol}), without "
          f"the last {CONTROL_ROWS} keys fused {misses['fused']:.3g} / split "
          f"{misses['split']:.3g} off", flush=True)
    fused_row = dict(ms=served, route=route, fused_ms=ms["fused"], split_ms=ms["split"],
                     fused_splits=fns, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                     library_ms=ms["library"], library=lib_name, case=label, q_scale=q_scale,
                     max_abs_err=max(errs.values()), control_err=misses["fused"],
                     serves=CELL_DA[case])
    part_row = dict(ms=ms["partials"], splits=pns, with_combine_ms=ms["split"],
                    plain_ms=plain_ms, bound_ms=p_bound_ms, bound_by=p_bound_by,
                    library_ms=ms["library"], library=lib_name, case=label, q_scale=q_scale,
                    max_abs_err=errs["split"], control_err=misses["split"],
                    serves=CELL_DA[case])
    return fused_row, part_row


def _cell_flash_case(b) -> dict:
    """Kernel 3 at the qwen3-1.7b prefill_32k layer (B ``b`` x 32,768 queries
    over a 32,768-row cache, H 16 / KV 8, D 128, causal: the "tc" route; q
    drawn x CELL_FA_Q_SCALE, rows planted among the last keys for the last
    query) against the plain twin run over query blocks of FA_BLOCK rows
    (each over the keys up to its last row, so no S^2 scores are held), the
    planted control (the last block of queries over all but the last
    CONTROL_ROWS keys must miss the twin), beside SDPA and the bound."""
    import torch
    import torch.nn.functional as tnf

    from repro_torch.kernels.flash_attention import kernel, ops

    s, h, kv, d = 32768, 16, 8, 128
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(s + d)
    q = (torch.randn((b, s, h, d), generator=g, device=dev) * CELL_FA_Q_SCALE).to(torch.bfloat16)
    k, v = (torch.randn((b, s, kv, d), generator=g, device=dev, dtype=torch.bfloat16)
            for _ in range(2))
    _plant_last_rows(q[:, -1], k, v, 0, s)
    kl = torch.full((1,), s, dtype=torch.int32, device=dev)
    kw = dict(causal=True, window=None, logit_softcap=None, q_offset_from_kv_len=True)
    assert kernel.route(q.dtype, s, d, h // kv, s) == "tc"

    def kernel_call():
        return ops.flash_attention(q, k, v, kl, **kw)

    before = ops.ROUTES["tc"]
    out = kernel_call()
    torch.cuda.synchronize()
    assert ops.ROUTES["tc"] == before + 1
    tol = FA_TOL["bfloat16"]
    t0 = time.perf_counter()
    err = 0.0
    for i0 in range(0, s, FA_BLOCK):  # the twin, one block of queries at a time
        i1 = i0 + FA_BLOCK
        want = ops.plain_bshd(q[:, i0:i1], k[:, :i1], v[:, :i1],
                              torch.full((1,), i1, dtype=torch.int32, device=dev), **kw).float()
        got = out[:, i0:i1].float()
        err = max(err, (got - want).abs().max().item())
        assert torch.allclose(got, want, rtol=tol, atol=tol), (
            f"flash tc at the prefill_32k layer differs from the twin by {err} (rows {i0}-)")
    plain_ms = (time.perf_counter() - t0) * 1e3
    # the control: the last block's queries over the keys before the last
    # CONTROL_ROWS (every one of which those queries see), as a kernel that
    # skipped the last key tiles would give them
    i0 = s - CONTROL_ROWS
    control = ops.flash_attention(q[:, i0:].contiguous(), k[:, :i0].contiguous(),
                                  v[:, :i0].contiguous(),
                                  torch.full((1,), i0, dtype=torch.int32, device=dev),
                                  **{**kw, "causal": False}).float()
    want = ops.plain_bshd(q[:, i0:], k, v, kl, **kw).float()
    miss = (control - want).abs().max().item()
    assert not torch.allclose(control, want, rtol=tol, atol=tol), (
        f"flash tc at the prefill_32k layer without the last {CONTROL_ROWS} keys stays within "
        f"{miss} of the twin: the tolerance does not bind")
    del control, want
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

    def library_call():
        return tnf.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)

    lib = library_call().transpose(1, 2)
    for i0 in range(0, s, 4096):  # in blocks: the f32 copies of all rows are 2 GB each
        x, y = lib[:, i0:i0 + 4096].float(), out[:, i0:i0 + 4096].float()
        assert torch.allclose(x, y, rtol=tol, atol=tol), (
            f"sdpa disagrees at the prefill_32k layer by {(x - y).abs().max().item()}")
    del lib
    ms = _time_ms(kernel_call, reps=5, warmup=1, inner=1)
    library_ms = _time_ms(library_call, reps=5, warmup=1, inner=1)
    t_ops = 4.0 * d * b * h * s * (s + 1) / 2 / BF16_OPS_PER_S * 1e3
    t_bytes = 2 * (2 * b * s * h * d + 2 * b * s * kv * d) / HBM_BYTES_PER_S * 1e3
    bound_ms, bound_by = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
    label = f"B={b} Sq=Skv={s} H={h} KV={kv} D={d} causal bf16 (tc)"
    print(f"[cells] kernel 3 at the qwen3-1.7b prefill_32k layer, {label}, q_scale "
          f"{CELL_FA_Q_SCALE}: max abs diff {err:.3g} (rtol = atol = {tol}; the twin over "
          f"{s // FA_BLOCK} query blocks, {plain_ms:.1f} ms; without the last {CONTROL_ROWS} "
          f"keys the last block is {miss:.3g} off); kernel {ms:.4f} ms, sdpa {library_ms:.4f} "
          f"ms, bound {bound_ms:.4f} ms ({bound_by}), {bound_ms / ms:.1%} of bound", flush=True)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms, library="sdpa", case=label, max_abs_err=err,
                q_scale=CELL_FA_Q_SCALE, control_err=miss,
                serves="qwen3-1.7b prefill_32k (a layer)")


def _cell_ssd_case(b) -> tuple:
    """Kernel 6 at the mamba2-370m prefill_32k layer (B ``b`` x 32,768 tokens,
    H 32, P 64, N 128, chunk 256: 128 chunks): the intra-chunk kernel (the
    "tc" route), then the inter-chunk kernel on its outputs from a given
    h0, each against its plain twin run SSD_BLOCK batch rows at a time ->
    (intra row, inter row)."""
    import torch

    from repro_torch.kernels.ssd_scan import kernel, ops, ref

    s, chunk, h, n = 32768, 256, 32, 128
    dev = torch.device("cuda")
    args = _ssd_inputs(b, s, h, n, dev, seed=s + n)
    assert kernel.route(args[0].dtype, chunk, SSD_P, n) == "tc"

    def kernel_call():
        return ops.intra_chunk(*args, chunk=chunk, final_state=True)

    got = kernel_call()
    result = {"max_abs_err": 0.0}
    t0 = time.perf_counter()
    for r0 in range(0, b, SSD_BLOCK):
        want = ref.intra_chunk_bshp(*(t[r0:r0 + SSD_BLOCK] for t in args), chunk=chunk,
                                    final_state=True)
        summary = _ssd_hold(f"ssd tc prefill_32k rows {r0}-", [t[r0:r0 + SSD_BLOCK] for t in got],
                            want, result)
    plain_ms = (time.perf_counter() - t0) * 1e3
    ms = _time_ms(kernel_call, reps=5, warmup=1, inner=1)
    (bound_ms, bound_by), nbytes = _ssd_bound(b, s, chunk, True, h, n)
    label = f"B={b} S={s} H={h} P={SSD_P} N={n} chunk={chunk} bf16 (tc, {s // chunk} chunks)"
    print(f"[cells] kernel 6 at the mamba2-370m prefill_32k layer, {label}: max abs diff "
          f"{result['max_abs_err']:.3g} (last rows: {summary}; the twin {SSD_BLOCK} rows at a "
          f"time, {plain_ms:.1f} ms); kernel {ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}, "
          f"{nbytes / 1e6:.1f} MB), {bound_ms / ms:.1%} of bound", flush=True)
    intra_row = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                     library_ms=None, case=label, max_abs_err=result["max_abs_err"],
                     serves="mamba2-370m prefill_32k (a layer)")

    # the inter-chunk kernel on those outputs, from a given h0 (a prefill into a cache)
    y_intra, s_contrib, cumexp = got
    cm = args[4]
    del args, got
    h0 = torch.randn((b, h, SSD_P, n), generator=torch.Generator(device=dev).manual_seed(s),
                     device=dev)
    y = y_intra.clone()
    before = ops.LAUNCHES["ssd_inter_chunk"]
    y, hf = ops.inter_chunk(y, s_contrib, cumexp, cm, h0, chunk=chunk)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["ssd_inter_chunk"] == before + 1, ops.LAUNCHES
    result = {"max_abs_err": 0.0}
    t0 = time.perf_counter()
    for r0 in range(0, b, SSD_BLOCK):
        rs = slice(r0, r0 + SSD_BLOCK)
        want = ref.inter_chunk_bshp(y_intra[rs], s_contrib[rs], cumexp[rs], cm[rs], h0[rs],
                                    chunk=chunk)
        summary = _ssd_hold(f"ssd inter prefill_32k rows {r0}-", (y[rs], hf[rs]), want, result,
                            INTER_OUTPUTS)
    plain_ms = (time.perf_counter() - t0) * 1e3
    layout = kernel.inter_layout(b, h, SSD_P, torch.cuda.get_device_properties(dev)
                                 .multi_processor_count)

    def inter_call():  # adds into y again on each call: the time is the same
        kernel.launch_inter(y, s_contrib, cumexp, cm, h0, hf, chunk=chunk, layout=layout)

    ms = _time_ms(inter_call, reps=5, warmup=1, inner=1)
    (bound_ms, bound_by), nbytes = _inter_bound(b, s, chunk, h, n, True, True)
    label = (f"B={b} S={s} H={h} P={SSD_P} N={n} chunk={chunk} ({s // chunk} chunks), bf16 C, "
             f"h0 given, {layout[0]} warps a block, {layout[1]} on rows")
    print(f"[cells] the inter-chunk kernel at the mamba2-370m prefill_32k layer, {label}: max "
          f"abs diff {result['max_abs_err']:.3g} (last rows: {summary}; the twin {SSD_BLOCK} "
          f"rows at a time, {plain_ms:.1f} ms); kernel {ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({bound_by}, {nbytes / 1e6:.1f} MB), {bound_ms / ms:.1%} of bound", flush=True)
    inter_row = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                     library_ms=None, case=label, max_abs_err=result["max_abs_err"],
                     serves="mamba2-370m prefill_32k (a layer)")
    return intra_row, inter_row


def _rope_on_card() -> str:
    """``rope_frequencies`` on the card bitwise the CPU's, and ``apply_rope``
    within ROPE_TOL of it at the long cells' positions -> a summary."""
    import torch

    from repro_torch.models.layers import apply_rope, rope_frequencies

    out = []
    pos = torch.tensor(ROPE_POSITIONS)
    for d, theta in ROPE_CASES:
        f_cpu, f_gpu = rope_frequencies(d, theta), rope_frequencies(d, theta, "cuda").cpu()
        ulps = int((f_cpu.view(torch.int32) - f_gpu.view(torch.int32)).abs().max())
        x = torch.randn((1, len(ROPE_POSITIONS), 2, d),
                        generator=torch.Generator().manual_seed(d))
        err = (apply_rope(x, pos, theta) - apply_rope(x.cuda(), pos.cuda(), theta).cpu())
        err = err.abs().max().item()
        assert ulps == 0 and err <= ROPE_TOL * x.abs().max().item(), (d, theta, ulps, err)
        out.append(f"D {d} theta {theta:g}: frequencies bitwise, apply_rope within {err:.3g}")
    return "; ".join(out)


def _cell_expected(cfg, batch: int, seq_len: int, kind: str, calls: int) -> dict:
    """The launches by route that ``calls`` prefills or decode steps of a
    long cell make."""
    import torch

    from repro_torch.kernels.decode_attention import ops as da_ops

    groups = cfg.num_layers // len(cfg.layer_pattern)
    want = {}

    def add(key):
        want[key] = want.get(key, 0) + groups * calls

    for mixer in cfg.layer_pattern:
        if mixer in ("mamba", "hymba"):  # the mixer's two kernels, prefill or step
            for key in MIXER_KERNELS:
                add(key)
        if kind == "prefill":
            if mixer in ("global", "local", "hymba"):
                add("flash_attention/tc")
            if mixer in ("mamba", "hymba"):
                add("ssd_intra_chunk/tc")
        elif mixer in ("global", "local", "hymba"):  # a hymba layer attends as "global"
            window = cfg.sliding_window + 1 if mixer == "local" else None
            route = da_ops.decode_route(torch.bfloat16, cfg.head_dim, batch * cfg.num_kv_heads,
                                        seq_len, window)
            if route == "split":
                add("decode_attention_fused/split")
                add("decode_attention_partials/tc")
            else:
                add("decode_attention_fused/tc")
    return want


def _gate(cell, seed: int) -> str:
    """The cell's kernel route against the plain engines on the card, over the
    same weights and cache, at one pattern period (two layers where the
    period is one) and the cell's full length: the logits within the
    model's tolerance of their largest magnitude."""
    import dataclasses

    import torch

    from repro_torch.launch import cells
    from repro_torch.models import transformer as tf
    from repro_torch.models.model import Model, random_model

    spec = cell.shape
    layers = max(2, len(cell.cfg.layer_pattern))
    cut = dataclasses.replace(cell.cfg, num_layers=layers)
    model, params = random_model(cut, seed=0, device="cuda")
    plain = Model(dataclasses.replace(model.cfg, attn_impl="auto"))
    tol = CELL_GATE_TOL.get(cell.arch, ZOO_GATE_TOL)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    with torch.no_grad():
        if spec.kind == "prefill":
            b = min(cell.batch, 2)
            batch = {"tokens": torch.randint(0, cut.vocab_size, (b, spec.seq_len),
                                             generator=gen, device="cuda")}
            got, _ = model.prefill(params, batch, spec.seq_len)
            want, _ = plain.prefill(params, batch, spec.seq_len)
        else:
            b = cell.batch
            cache = tf.init_model_cache(cut, b, spec.seq_len, cut.activation_dtype,
                                        device="cuda")
            cache = cells.fill_cache(cache, gen, spec.seq_len - 1)
            state = [t for t in cache.ssm_conv + cache.ssm_h if t is not None]
            saved = [t.clone() for t in state]
            token = torch.randint(0, cut.vocab_size, (b, 1), generator=gen, device="cuda")
            got, _ = model.decode_step(params, token, cache)
            for t, s in zip(state, saved):  # the step advanced the SSM state in place
                t.copy_(s)
            want, _ = plain.decode_step(params, token, cache)
    err = ((got - want).abs().max() / want.abs().max()).item()
    same = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    assert bool(torch.isfinite(got).all()) and err <= tol, (
        f"{cell.arch} x {spec.name}: the kernel route's logits differ from the plain engines' "
        f"by {err} of their scale (tol {tol})")
    return (f"gate at {layers} layers, B {b}, the full length: logits within {err:.3g} of "
            f"their scale (tol {tol}), argmax equal on {same:.0%} of rows")


def phase_long_cells() -> tuple:
    """Phase 9b: the reference's serve cells on one card (``launch/cells.py``):
    RoPE at their positions (card vs CPU), each kernel at the shape a cell
    gives it (``CELL_DA``, the flash and SSD prefill layers) against its plain
    version, then each cell at ``one_card_cell``'s batch and depth through
    ``build_prefill_step`` / ``build_decode_step`` (random bf16 weights, a
    ``fill_cache``d cache for the decodes): the launches by route, ms a
    prefill or step (host clock, synchronised, median), tokens/s, peak
    memory, then its gate (``_gate``) -> (launches, kernel rows by name)."""
    import gc

    import torch

    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssm_mixer import ops as mixer_ops
    from repro_torch.launch import cells
    from repro_torch.launch import steps as st
    from repro_torch.models import transformer as tf
    from repro_torch.models.model import random_model

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[cells] RoPE on the card vs the CPU at positions {ROPE_POSITIONS}: "
          f"{_rope_on_card()}", flush=True)
    sized = [cells.one_card_cell(arch, shape) for arch, shape in cells.SERVE_CELLS]
    rows = {"decode_attention_fused": [], "decode_attention_partials_tc": []}
    for case, label in CELL_DA.items():
        fused_row, part_row = _cell_decode_case(case, label)
        rows["decode_attention_fused"].append(fused_row)
        rows["decode_attention_partials_tc"].append(part_row)
        gc.collect()
        torch.cuda.empty_cache()
    by_cell = {(c.arch, c.shape.kind): c for c in sized}
    rows["flash_attention_tc"] = [_cell_flash_case(by_cell["qwen3-1.7b", "prefill"].batch)]
    gc.collect()
    torch.cuda.empty_cache()
    intra_row, inter_row = _cell_ssd_case(by_cell["mamba2-370m", "prefill"].batch)
    rows["ssd_intra_chunk_tc"], rows["ssd_inter_chunk"] = [intra_row], [inter_row]
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[cells] kernel cases in {time.perf_counter() - t_phase:.1f} s", flush=True)

    counted = (fa_ops, da_ops, ssd_ops, mixer_ops)
    launches = {}
    for i, cell in enumerate(sized):
        cfg, spec, b = cell.cfg, cell.shape, cell.batch
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model, params = random_model(cfg, seed=0, device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(100 + i)
        times = []
        if spec.kind == "prefill":
            step = st.build_prefill_step(model.cfg, spec)
            batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, spec.seq_len),
                                             generator=gen, device="cuda")}
            logits, cache = step.fn(params, {"tokens": batch["tokens"][:1]})  # warm-up, one row
            del logits, cache
            torch.cuda.synchronize()
            setup_s = time.perf_counter() - t0
            for c in counted:
                c.reset_counts()
            for _ in range(CELL_PREFILLS):
                t1 = time.perf_counter()
                logits, cache = step.fn(params, batch)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t1)
                assert bool(torch.isfinite(logits).all()), cell
                assert logits.shape == (b, 1, cfg.vocab_size), cell
                assert int(cache.length) == spec.seq_len
                del logits, cache
            tokens, calls = b * spec.seq_len, CELL_PREFILLS
        else:
            step = st.build_decode_step(model.cfg, spec)
            cache = tf.init_model_cache(cfg, b, spec.seq_len, cfg.activation_dtype,
                                        device="cuda")
            cache = cells.fill_cache(cache, gen, spec.seq_len - 1)
            token = torch.randint(0, cfg.vocab_size, (b, 1), generator=gen, device="cuda")
            logits, _ = step.fn(params, token, cache)  # warm-up
            torch.cuda.synchronize()
            setup_s = time.perf_counter() - t0
            for c in counted:
                c.reset_counts()
            for _ in range(CELL_STEPS):  # each step writes the last free row again
                token = logits.argmax(-1)
                t1 = time.perf_counter()
                logits, after = step.fn(params, token, cache)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t1)
                assert bool(torch.isfinite(logits).all()), cell
                assert logits.shape == (b, 1, cfg.vocab_size), cell
                assert int(after.length) == spec.seq_len
            del cache, after, logits
            tokens, calls = b, CELL_STEPS
        run = _launches(fa_ops, da_ops, ssd_ops, mixer_ops)
        plain = {**fa_ops.PLAIN_CALLS, **da_ops.PLAIN_CALLS, **ssd_ops.PLAIN_CALLS,
                 **mixer_ops.PLAIN_CALLS}
        peak = torch.cuda.max_memory_allocated()
        want = _cell_expected(cfg, b, spec.seq_len, spec.kind, calls)
        got = {k: n for k, n in run.items() if ("/" in k or k in MIXER_KERNELS) and n}
        assert got == want, (cell.arch, spec.name, got, want)
        # every SSD layer of a prefill runs the recurrence from the cache's state
        assert run["ssd_inter_chunk"] == run["ssd_intra_chunk"], run
        assert not any(plain.values()), f"plain path ran on the {cell.arch} cell: {plain}"
        for k, n in run.items():
            launches[k] = launches.get(k, 0) + n
        ms = statistics.median(times) * 1e3
        del model, params, step
        gc.collect()
        torch.cuda.empty_cache()
        gate = _gate(cell, 200 + i)
        what = (f"prefill B={b} x {spec.seq_len} tokens" if spec.kind == "prefill" else
                f"decode B={b} over {spec.seq_len} keys (a cache at {spec.seq_len - 1})")
        print(f"[cells] {cell.arch} x {spec.name} ({cfg.num_layers} layers, bf16; reduced: "
              f"{'; '.join(cell.reduced) or 'nothing'}; reckoned {cell.total_bytes / 1e9:.1f} "
              f"GB, of it {cell.activation_bytes / 1e9:.1f} activations): {what}: {ms:.3f} ms "
              f"median of {calls} ({min(times) * 1e3:.3f}-{max(times) * 1e3:.3f}; host clock, "
              f"synchronised), {tokens / ms * 1e3:.0f} tokens/s; setup {setup_s:.1f} s; peak "
              f"{peak / 2**30:.3f} GiB ({peak / 1e9:.2f} GB); launches {got}; {gate}",
              flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    print(f"[cells] {len(sized)} cells in {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches, rows


def _train_grads(cfg, params, batch):
    """loss_fn and autograd on ``params``' device -> (loss, metrics, every
    gradient leaf)."""
    import torch

    from repro_torch.models.model import Model
    from repro_torch.optim.tree import leaves, tree_map

    p = tree_map(lambda t: t.detach().requires_grad_(True), params)
    loss, metrics = Model(cfg).loss_fn(p, batch)
    grads = torch.autograd.grad(loss, leaves(p), allow_unused=True, materialize_grads=True)
    return loss.item(), {k: v.item() for k, v in metrics.items()}, grads


def _all_counts() -> dict:
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.enrich_score import ops as es_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssm_mixer import ops as mixer_ops

    return {**_launches(fa_ops, da_ops, ssd_ops, mixer_ops), **_es_counts(es_ops),
            **{f"plain/{k}": n for ops in (fa_ops, da_ops, ssd_ops, mixer_ops, es_ops)
               for k, n in ops.PLAIN_CALLS.items()}}


def _reset_all_counts() -> None:
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.enrich_score import ops as es_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssm_mixer import ops as mixer_ops
    from repro_torch.models import attention

    for ops in (fa_ops, da_ops, ssd_ops, mixer_ops, es_ops, attention):
        ops.reset_counts()


def phase_train_cpu_vs_gpu() -> None:
    """The smoke models in f32 from the same weights and batches on the CPU
    and the card: the loss, metrics, grad norm and every gradient leaf, then
    ``TRAIN_CHECK_SHAPE``'s AdamW steps through ``build_train_step``.  No
    kernel launches (training runs the plain engines)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs.archs import get_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.data.pipeline import SyntheticTokenStream, TokenStreamConfig, to_device
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import global_norm
    from repro_torch.optim.tree import leaves, tree_map

    seq, rows, mb, n_steps = TRAIN_CHECK_SHAPE
    dev = torch.device("cuda")
    for arch in TRAIN_CHECK:
        cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
        params = Model(cfg).init_params(torch.Generator().manual_seed(0))
        stream = SyntheticTokenStream(TokenStreamConfig(cfg.vocab_size, seq, rows))
        _reset_all_counts()
        cpu = _train_grads(cfg, params, to_device(stream.batch(0), "cpu"))
        gpu = _train_grads(cfg, tree_map(lambda t: t.to(dev), params),
                           to_device(stream.batch(0), dev))
        assert abs(gpu[0] - cpu[0]) <= 1e-4 * abs(cpu[0]), (arch, gpu[0], cpu[0])
        for k in cpu[1]:
            assert abs(gpu[1][k] - cpu[1][k]) <= 1e-4 * abs(cpu[1][k]), (arch, k)
        worst = 0.0
        for gg, gc_ in zip(gpu[2], cpu[2]):
            scale = max(gc_.abs().max().item(), 1e-12)
            worst = max(worst, (gg.cpu() - gc_).abs().max().item() / scale)
        assert worst <= TRAIN_GRAD_TOL, (arch, worst)
        norms = [global_norm(list(g)).item() for g in (cpu[2], [t.cpu() for t in gpu[2]])]
        built = build_train_step(cfg, ShapeSpec("check", "train", seq, rows), num_microbatches=mb,
                                 donate=False)
        runs = {}
        for d in ("cpu", dev):
            p = tree_map(lambda t: t.to(d), params)
            s = built.optimizer.init(p)
            losses = []
            for step in range(n_steps):
                p, s, m = built.fn(p, s, to_device(stream.batch(step), d))
                losses.append(m["loss"].item())
            runs[str(d)] = (losses, [t.cpu() for t in leaves(p)])
        lr, loose, total, far = built.optimizer.lr, 0, 0, 0.0
        for a, b in zip(runs["cuda"][1], runs["cpu"][1]):
            diff = (a - b).abs()
            far = max(far, diff.max().item())
            loose += int((diff > 0.01 * lr).sum())
            total += diff.numel()
        counts = _all_counts()
        moved = {k: n for k, n in counts.items() if n and not k.startswith("plain/")}
        print(f"[train] {arch} smoke (f32) CPU vs card: loss {cpu[0]:.6f} / {gpu[0]:.6f}, grad "
              f"norm {norms[0]:.6f} / {norms[1]:.6f}, every gradient leaf within {worst:.3g} of "
              f"its scale (tol {TRAIN_GRAD_TOL}); after {n_steps} AdamW steps losses "
              f"{runs['cpu'][0]} / {runs['cuda'][0]}, parameters within {far / lr:.4f} lr "
              f"({loose} of {total} beyond 0.01 lr); kernel launches {moved or 0}", flush=True)
        assert not moved, moved
        np.testing.assert_allclose(runs["cuda"][0], runs["cpu"][0], rtol=1e-4)
        assert far <= 2 * lr * n_steps and loose <= 1e-3 * total, (arch, far / lr, loose)


def phase_train_main_path() -> dict:
    """qwen3-1.7b at full width (28 layers, d 2,048, 1,720,451,072 parameters,
    random f32 weights, bf16 activations) through ``launch.train.train_loop``:
    ``TRAIN_FULL``'s AdamW steps on the chunked attention engine with remat.
    Every loss finite and the last below the first, no kernel launched, the
    chunked engine ran -> the numbers for the report."""
    import gc

    import numpy as np
    import torch

    from repro_torch.configs.archs import get_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch import train
    from repro_torch.models import attention

    arch, seq, rows, mb, n_steps = TRAIN_FULL
    cfg = get_config(arch)
    assert (cfg.num_layers, cfg.d_model, cfg.param_counts()["total"]) == (28, 2048, 1_720_451_072)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_all_counts()
    t0 = time.perf_counter()
    params, state, hist = train.train_loop(cfg, ShapeSpec("train_4k-cut", "train", seq, rows),
                                           n_steps, device="cuda", num_microbatches=mb,
                                           log_every=1)
    wall = time.perf_counter() - t0
    counts = _all_counts()
    engine = dict(attention.ENGINE_CALLS)
    peak = torch.cuda.max_memory_allocated()
    del params, state
    gc.collect()
    torch.cuda.empty_cache()
    losses = [h["loss"] for h in hist]
    step_ms = [h["sec"] * 1e3 for h in hist]
    ms = statistics.median(step_ms[1:])
    tokens_s = rows * seq / (ms / 1e3)
    print(f"[train] {arch} at full width: {n_steps} AdamW steps of {rows} x {seq} tokens "
          f"({mb} microbatches), losses {losses}; step ms {[round(t, 2) for t in step_ms]}, "
          f"median of steps 2-{n_steps} {ms:.2f} ms = {tokens_s:.0f} tokens/s; peak memory "
          f"{peak / 2**30:.3f} GiB; attention engine calls {engine}; {wall:.1f} s in all",
          flush=True)
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    assert not any(counts.values()), {k: n for k, n in counts.items() if n}
    assert engine["dense"] == 0 and engine["chunked"] >= cfg.num_layers * mb * n_steps * (
        seq // attention.DEFAULT_Q_CHUNK), engine
    return dict(losses=losses, step_ms=step_ms, ms=ms, tokens_s=tokens_s, peak_bytes=peak,
                engine_calls=engine)


def phase_train_resume() -> dict:
    """``train_loop`` checkpointed at ``TRAIN_RESUME_AT`` and resumed in a
    fresh loop equals the uninterrupted run bitwise (qwen3-1.7b at full
    width, ``TRAIN_RESUME_LAYERS`` layers): run in a child process
    that sets ``CUBLAS_WORKSPACE_CONFIG`` before cuBLAS starts and runs under
    ``torch.use_deterministic_algorithms(True)``."""
    import shutil

    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--train-resume"],
                          env=env, capture_output=True, text=True, timeout=900)
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    sys.stdout.write(proc.stdout)
    sys.stderr.write(proc.stderr[-4000:])
    if proc.returncode:
        raise AssertionError(f"the resume check exited {proc.returncode}")
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    print(f"[train] resume check passed in {time.perf_counter() - t0:.1f} s", flush=True)
    return result


def train_resume_child() -> int:
    """The child of ``phase_train_resume``: the uninterrupted run, then a run
    cut at ``TRAIN_RESUME_AT`` that checkpoints, then a fresh loop that
    restores and finishes; the resumed losses and every parameter and
    optimiser-state leaf must equal the uninterrupted run's bitwise."""
    import dataclasses
    import gc

    import torch

    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.configs.archs import get_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch import train
    from repro_torch.optim.tree import leaves

    torch.use_deterministic_algorithms(True)
    arch, seq, rows, mb, n_steps = TRAIN_FULL
    cfg = dataclasses.replace(get_config(arch), num_layers=TRAIN_RESUME_LAYERS)
    shape = ShapeSpec("train_4k-cut", "train", seq, rows)
    kw = dict(device="cuda", num_microbatches=mb, log_every=n_steps)

    def host(params, state):
        return [t.cpu() for t in leaves((params, (state.step, state.mu, state.nu)))]

    p, s, whole = train.train_loop(cfg, shape, n_steps, **kw)
    want = host(p, s)
    del p, s
    gc.collect()
    torch.cuda.empty_cache()
    p, s, first = train.train_loop(cfg, shape, TRAIN_RESUME_AT, ckpt_dir=str(TRAIN_DIR),
                                   ckpt_every=TRAIN_RESUME_AT, **kw)
    del p, s
    gc.collect()
    torch.cuda.empty_cache()
    ckpt_bytes = sum(f.stat().st_size for f in TRAIN_DIR.rglob("*") if f.is_file())
    p, s, rest = train.train_loop(cfg, shape, n_steps, ckpt_dir=str(TRAIN_DIR), **kw)
    got = host(p, s)
    losses = [h["loss"] for h in first + rest]
    same = [h["loss"] for h in whole] == losses and all(
        torch.equal(a, b) for a, b in zip(got, want))
    print(f"[train] resume: uninterrupted losses {[h['loss'] for h in whole]}, cut at step "
          f"{TRAIN_RESUME_AT} and resumed {losses}; {len(got)} leaves bitwise equal: {same}; "
          f"checkpoint {ckpt_bytes / 1e9:.2f} GB", flush=True)
    assert [h["step"] for h in rest] == list(range(TRAIN_RESUME_AT, n_steps))
    assert same
    print(json.dumps({"bitwise": same, "losses": losses, "checkpoint_bytes": ckpt_bytes}))
    return 0


# phase 8, the model mesh on a one-rank NCCL group and a (1, 1) ("data",
# "model") mesh: arch, batch, prompt, greedy decode steps, cache rows (phase
# 7's serve paths; mamba2 runs its prefill only), and a train step of
# qwen3-1.7b at full width cut to MESH_TRAIN's layers (the one-device step
# beside it, in the same child: time, not memory, cuts the depth)
# and nemotron-4-15b at its published width cut to 2 of 32 layers (a G 6, D
# 128 decode group: the partials kernel's tc form at 6 query rows a kv head);
# arch, batch, prompt, decode steps, cache, layers (None: the published depth)
MESH_SERVE = (("qwen3-1.7b", 8, 2048, 32, 4096, None), ("mamba2-370m", 2, 4096, 0, 4128, None),
              ("nemotron-4-15b", 1, 2048, 4, 2080, 2))
MESH_TRAIN = ("qwen3-1.7b", 4, 4096, 2)  # arch, layers, seq, batch
MESH_LOGIT_TOL = 2e-2  # bf16 logits, of their largest magnitude
MESH_LOSS_RTOL = 1e-5  # the train step's loss: f32
MESH_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_mesh"


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _mesh_serve(mesh, arch, b, prompt, steps, max_len, layers) -> dict:
    """``arch`` at full width (random bf16 weights, the kernel route; depth
    cut to ``layers`` when given) through
    ``build_prefill_step`` and ``steps`` ``build_decode_step``s on ``mesh``,
    beside the mesh-free ``Model.prefill`` / ``decode_step`` on the same
    weights: the mesh decode is fed the mesh-free run's greedy tokens, and
    each step's logits must agree within MESH_LOGIT_TOL of their scale and
    pick the same token (unless the mesh-free run's top two are closer than
    the two runs' distance)."""
    import dataclasses
    import gc

    import torch

    from repro_torch.configs.archs import get_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import steps as st
    from repro_torch.launch.rules import rules_for_cell
    from repro_torch.models.model import random_model

    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    model, params = random_model(cfg, seed=0, device="cuda")
    cfg, n = model.cfg, model.cfg.num_layers
    g = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (b, prompt), generator=g, device="cuda")
    _generate(model, params, tokens[:, :256], 2, 512)  # warm-up (cuBLAS, allocator)

    def timed(fn, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    timed(model.prefill, params, {"tokens": tokens}, max_len)  # its shapes' first call
    (logits, cache), free_prefill_ms = timed(model.prefill, params, {"tokens": tokens}, max_len)
    want, feed, free_step_ms = [logits.float()], [], []
    for _ in range(steps):
        feed.append(logits.argmax(-1))
        (logits, cache), ms = timed(model.decode_step, params, feed[-1], cache)
        want.append(logits.float())
        free_step_ms.append(ms)
    del cache, logits
    anchor = _f32_anchor(cfg, tokens, feed, max_len) if steps else []
    gc.collect()
    torch.cuda.empty_cache()

    rules = rules_for_cell(cfg, mesh, "prefill", b)
    dparams = st.distribute_params(params, model.param_axes(), rules, mesh)
    pshape = ShapeSpec("mesh", "prefill", max_len, b)
    dshape = ShapeSpec("mesh", "decode", max_len, b)
    prefill = st.build_prefill_step(cfg, pshape, mesh)
    decode = st.build_decode_step(cfg, dshape, mesh)
    batch = st.distribute_batch({"tokens": tokens}, cfg, pshape, mesh)
    (_, first), first_prefill_ms = timed(prefill.fn, dparams, batch)  # DTensor's first call
    del first
    _reset_all_counts()
    torch.cuda.reset_peak_memory_stats()
    (logits, cache), mesh_prefill_ms = timed(prefill.fn, dparams, batch)
    prefill_counts = _all_counts()
    routes = dict(fa_ops.ROUTES)
    got, mesh_step_ms = [logits.full_tensor().float()], []
    _reset_all_counts()
    for tok in feed:
        tok = st.distribute_batch({"token": tok}, cfg, dshape, mesh)["token"]
        (logits, cache), ms = timed(decode.fn, dparams, tok, cache)
        got.append(logits.full_tensor().float())
        mesh_step_ms.append(ms)
    decode_counts = _all_counts()
    peak = torch.cuda.max_memory_allocated()
    worst, bitwise, flips, over, errs = 0.0, True, 0, [], []
    for i, (w_, g_) in enumerate(zip(want, got)):
        diff = float((w_ - g_).abs().max())
        scale = float(w_.abs().max())
        worst = max(worst, diff / scale)
        errs.append(round(diff / scale, 5))
        bitwise = bitwise and diff == 0.0
        # a decode step may also stand within 2x the mesh-free bf16 run's own
        # distance from the f32 run (the fused kernel rounds P to bf16 on the
        # tensor cores, the partials kernel keeps f32; 28 layers compound it)
        own = float((w_ - anchor[i]).abs().max()) / scale if i and anchor else 0.0
        if diff / scale > max(MESH_LOGIT_TOL, 2 * own):
            over.append((i, diff / scale, own))
        top2 = w_.topk(2, dim=-1).values
        near = (top2[..., 0] - top2[..., 1]) <= diff  # a near tie may flip
        flips += int(((w_.argmax(-1) != g_.argmax(-1)) & ~near).sum())
    moved = {k: prefill_counts[k] + decode_counts[k] for k in prefill_counts
             if prefill_counts[k] + decode_counts[k]}
    print(f"[mesh] {arch} at full width ({n} layers, bf16, kernel route, G "
          f"{cfg.num_heads // max(cfg.num_kv_heads, 1)}) on {tuple(mesh.shape)} "
          f"{mesh.mesh_dim_names}: prefill B={b} x {prompt} {mesh_prefill_ms:.2f} ms on the mesh "
          f"(first call {first_prefill_ms:.2f} ms) vs {free_prefill_ms:.2f} ms mesh-free (each "
          f"the second call at its shape); "
          + (f"{steps} decode steps {statistics.median(mesh_step_ms):.3f} ms median vs "
             f"{statistics.median(free_step_ms):.3f} ms; " if steps else "")
          + f"logits within {worst:.3g} of scale (tol {MESH_LOGIT_TOL}, or for a decode step "
          f"2x the mesh-free run's distance from f32; by step {errs}), bitwise {bitwise}, "
          f"greedy flips outside near ties {flips}; flash routes {routes}; launches {moved}; "
          f"peak memory {peak / 2**30:.3f} GiB", flush=True)
    assert not over and flips == 0, (arch, over, flips)
    assert all(torch.isfinite(x).all() for x in got)
    plain = {k: v for k, v in moved.items() if k.startswith("plain/")}
    assert not plain, plain
    if cfg.num_heads:  # tc flash on the local heads, the partials on the kv_seq shard,
        # every partials launch on the tc form (bf16, D 128; G 2 and G 6)
        assert prefill_counts["flash_attention/tc"] == n and routes["tc"] == n, prefill_counts
        assert decode_counts["decode_attention_partials"] == n * steps, decode_counts
        assert decode_counts["decode_attention_partials/tc"] == n * steps, decode_counts
        assert decode_counts["decode_attention_fused"] == 0, decode_counts
    else:  # the mixer's kernels and the SSD's on the rank's local shards
        assert prefill_counts["ssd_intra_chunk/tc"] == n, prefill_counts
        assert prefill_counts["ssd_inter_chunk"] == n, prefill_counts
        for key in MIXER_KERNELS:
            assert prefill_counts[key] == n and decode_counts[key] == n * steps, (
                prefill_counts, decode_counts)
    launches = {k: prefill_counts.get(k, 0) + decode_counts.get(k, 0)
                for k in ("flash_attention", "flash_attention/tc", "ssd_intra_chunk",
                          "ssd_intra_chunk/tc", "ssd_inter_chunk", "decode_attention_partials",
                          "decode_attention_partials/tc", "decode_attention_partials/simt",
                          *MIXER_KERNELS)}
    return dict(prefill_ms=mesh_prefill_ms, first_prefill_ms=first_prefill_ms,
                free_prefill_ms=free_prefill_ms,
                step_ms=statistics.median(mesh_step_ms) if steps else None,
                free_step_ms=statistics.median(free_step_ms) if steps else None,
                max_rel_err=worst, bitwise=bitwise, peak_bytes=peak, launches=launches)


def _f32_anchor(cfg, tokens, feed, max_len) -> list:
    """The same weights in f32 (the draws the bf16 tree was cast from) through
    the mesh-free prefill and decode steps fed ``feed``, on the plain
    engines ("auto": the fused decode kernel's simt form does not hold a
    group of 6 heads of 128 in f32) -> logits per step."""
    import dataclasses

    import torch

    from repro_torch.models.model import Model

    model = Model(dataclasses.replace(cfg, dtype="float32", attn_impl="auto"))
    params = model.init_params(torch.Generator(device="cuda").manual_seed(0))
    logits, cache = model.prefill(params, {"tokens": tokens}, max_len)
    out = [logits.float()]
    for tok in feed:
        logits, cache = model.decode_step(params, tok, cache)
        out.append(logits.float())
    return out


def _mesh_train(mesh) -> dict:
    """One AdamW step of qwen3-1.7b at full width (MESH_TRAIN's layers, f32
    parameters, bf16 activations) through ``build_train_step`` on ``mesh``
    and on one device, from the same parameters and batch."""
    import dataclasses

    import torch

    from repro_torch.configs.archs import get_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.data.pipeline import SyntheticTokenStream, TokenStreamConfig, to_device
    from repro_torch.launch import steps as st
    from repro_torch.models.model import Model
    from repro_torch.optim.tree import leaves

    arch, layers, seq, rows = MESH_TRAIN
    cfg = dataclasses.replace(get_config(arch), num_layers=layers)
    shape = ShapeSpec("train_4k-cut", "train", seq, rows)
    model = Model(cfg)
    params = model.init_params(torch.Generator(device="cuda").manual_seed(0))
    batch = to_device(SyntheticTokenStream(TokenStreamConfig(cfg.vocab_size, seq, rows)).batch(0),
                      "cuda")
    one = st.build_train_step(cfg, shape, donate=False)
    on_mesh = st.build_train_step(cfg, shape, donate=False, mesh=mesh)
    dparams = st.distribute_params(params, model.param_axes(), on_mesh.rules, mesh)
    out = {}
    for name, built, p, b in (("one", one, params, batch),
                              ("mesh", on_mesh, dparams, st.distribute_batch(
                                  batch, cfg, shape, mesh, on_mesh.rules))):
        s = built.optimizer.init(p)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p2, _, m = built.fn(p, s, b)
        torch.cuda.synchronize()
        out[name] = (float(m["loss"]), [t.full_tensor() if hasattr(t, "full_tensor") else t
                                        for t in leaves(p2)], (time.perf_counter() - t0) * 1e3)
    lr = one.optimizer.lr
    far = max(float((a - b_).abs().max()) for a, b_ in zip(out["one"][1], out["mesh"][1]))
    bitwise = far == 0.0 and out["one"][0] == out["mesh"][0]
    print(f"[mesh] {arch} train step at full width, {layers} of 28 layers, {rows} x {seq} tokens: "
          f"loss {out['mesh'][0]:.6f} on the mesh vs {out['one'][0]:.6f} on one device, "
          f"parameters within {far / lr:.4f} lr, bitwise {bitwise}; {out['mesh'][2]:.1f} ms "
          f"(DTensor's first call) vs {out['one'][2]:.1f} ms", flush=True)
    assert abs(out["mesh"][0] - out["one"][0]) <= MESH_LOSS_RTOL * abs(out["one"][0])
    assert far <= 2 * lr, far / lr
    return dict(loss=out["mesh"][0], one_loss=out["one"][0], far_lr=far / lr, bitwise=bitwise,
                ms=out["mesh"][2], one_ms=out["one"][2])


def model_mesh_child() -> int:
    """Phase 8's child: a one-rank NCCL group (never gloo on the card), the
    (1, 1) mesh, the serve paths and the train step on it."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.launch.mesh import make_host_mesh

    if not dist.is_nccl_available():
        raise RuntimeError("the model mesh phase runs on NCCL, which this torch lacks")
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}", rank=0,
                            world_size=1)
    try:
        mesh = make_host_mesh(model=1, device_type="cuda")
        serve = {arch: _mesh_serve(mesh, arch, *rest) for arch, *rest in MESH_SERVE}
        train = _mesh_train(mesh)
    finally:
        dist.destroy_process_group()
    print(json.dumps({"serve": serve, "train": train}))
    return 0


def mesh_gloo_child() -> int:
    """The suite's 2- and 4-rank gloo checks of the mesh steps and of the
    session mesh on the CPU, under the torch the script runs with
    (``tests/_torch_mesh_worker.gloo_checks``,
    ``tests/_torch_session_mesh_worker.gloo_checks``)."""
    import shutil

    root = Path(__file__).resolve().parent
    sys.path[:0] = [str(root / "src"), str(root / "tests")]
    import _torch_mesh_worker
    import _torch_session_mesh_worker

    MESH_DIR.mkdir(parents=True, exist_ok=True)
    try:
        seconds = _torch_mesh_worker.gloo_checks(MESH_DIR)
        session_seconds = _torch_session_mesh_worker.gloo_checks(MESH_DIR)
    finally:
        shutil.rmtree(MESH_DIR, ignore_errors=True)
    print(f"[session-mesh] gloo: the 2- and 4-rank session-mesh checks passed in "
          f"{session_seconds} s", flush=True)
    print(json.dumps({"gloo_seconds": seconds, "session_gloo_seconds": session_seconds}))
    return 0


def start_mesh_gloo():
    """Start the gloo checks in a CPU-only child beside the card phases."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    log = open(Path(__file__).resolve().parent / "build" / "chip_smoke_mesh_gloo.log", "w")
    return subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--mesh-gloo"],
                            env=env, stdout=log, stderr=subprocess.STDOUT, text=True), log


def phase_model_mesh(gloo) -> dict:
    """Phase 8: the model mesh's child (the serve paths and the train step
    on a one-rank NCCL mesh), then the gloo checks' child started with the
    run -> the mesh run's launches."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--model-mesh"],
                          capture_output=True, text=True, timeout=900)
    sys.stdout.write(proc.stdout)
    sys.stderr.write(proc.stderr[-4000:])
    if proc.returncode:
        raise AssertionError(f"the model mesh child exited {proc.returncode}")
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    mesh_s = time.perf_counter() - t0
    child, log = gloo
    code = child.wait(timeout=900)
    log.close()
    text = (Path(__file__).resolve().parent / "build" / "chip_smoke_mesh_gloo.log").read_text()
    sys.stdout.write("".join(line for line in text.splitlines(True)
                             if "Warning" not in line and "alltoall" not in line))
    if code:
        raise AssertionError(f"the gloo mesh checks exited {code}")
    gloo_s = json.loads(text.strip().splitlines()[-1])["gloo_seconds"]
    serve = result["serve"]
    line = {"card": _nvidia_smi(), "mesh": [1, 1],
            "qwen3-1.7b": {k: serve["qwen3-1.7b"][k] for k in (
                "prefill_ms", "free_prefill_ms", "step_ms", "free_step_ms", "peak_bytes",
                "max_rel_err", "bitwise")},
            "mamba2-370m": {k: serve["mamba2-370m"][k] for k in (
                "prefill_ms", "free_prefill_ms", "peak_bytes", "max_rel_err", "bitwise")},
            "nemotron-4-15b": {k: serve["nemotron-4-15b"][k] for k in (
                "prefill_ms", "free_prefill_ms", "step_ms", "free_step_ms", "peak_bytes",
                "max_rel_err", "bitwise")},
            "train": result["train"], "gloo_seconds": gloo_s, "phase_s": mesh_s}
    print(f"[mesh] {json.dumps(line)}", flush=True)
    launches = {}
    for run in serve.values():
        for k, v in run["launches"].items():
            launches[k] = launches.get(k, 0) + v
    return launches


# ------------------------------------------------------- the session mesh --

SESSION_MESH_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_session_mesh"
SESSION_ROWS = 1 << 20  # phase 4's world after MAIN_TRACE's ingest


def _session_serve(mesh, plan_shards: int = 1) -> dict:
    """Phase 4's world (placed on ``mesh`` unless it is None) serves
    MAIN_TRACE, then its grown state runs 8 table-mode epochs -> the two
    reports' digests, times, launches and collectives."""
    import torch

    from repro_torch.core import shard_program
    from repro_torch.core.durability import shard_session_state
    from repro_torch.core.executor import EngineConfig
    from repro_torch.core.session import EngineSession
    from repro_torch.kernels.enrich_score import ops
    from repro_torch.launch import serve

    session, state, pool, preds = _robust_world(plan_shards)
    if mesh is not None:
        state = shard_session_state(state, mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    shard_program.reset_counts()
    rep = serve.serve_session_trace(session, state, serve.parse_trace(MAIN_TRACE), pool=pool,
                                    preds=preds)
    trace_coll = dict(shard_program.COLLECTIVES)
    table = EngineSession(
        session.global_predicates, session.table, session.combine_params, session.costs,
        capacity=rep.state.capacity, max_tenants=8, device="cuda",
        config=EngineConfig(plan_size=64, substrate_dtype="bfloat16"))
    shard_program.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    final, hist = table.run(rep.state, 8, stop_when_exhausted=False)
    torch.cuda.synchronize()
    table_s = time.perf_counter() - t0
    launches, plain = _es_counts(ops), dict(ops.PLAIN_CALLS)
    assert not any(plain.values()), f"the plain path ran: {plain}"
    assert launches == _es_expect(table=8, best=24), launches
    runs = {k: session.program.program_runs[k] + table.program.program_runs[k]
            for k in session.program.program_runs}
    want = "device" if mesh is None else "per_rank"
    assert runs[want] > 0 and sum(runs.values()) == runs[want], runs
    assert rep.epochs == 24 and len(hist) == 8 and rep.num_rows == SESSION_ROWS
    return dict(trace=serve.state_digests(rep.state), table=serve.state_digests(final),
                trace_eps=rep.epochs / rep.wall_s, table_eps=8 / table_s,
                trace_collectives=trace_coll, table_collectives=dict(shard_program.COLLECTIVES),
                peak_bytes=torch.cuda.max_memory_allocated(), launches=launches, runs=runs)


def _session_staged(mesh, want) -> None:
    """The pipeline's staging of MAIN_TRACE on the placed state (host pool:
    the pinned copy path) under sync debug mode "error": no host sync on
    the mesh path either; its digests equal the lockstep run's."""
    import torch

    from repro_torch.core.durability import shard_session_state
    from repro_torch.launch import serve

    session, state, pool, preds = _robust_world()
    pipe = session.pipeline(shard_session_state(state, mesh))
    host_pool = pool.cpu()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _stage_trace(pipe, serve.parse_trace(MAIN_TRACE), host_pool, preds)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    grown, _ = pipe.finish()
    assert serve.state_digests(grown) == want, "the staged mesh pipeline's digests differ"


def _session_supervised(mesh) -> dict:
    """``kill:w1@chunk:4`` on 2 plan shards, supervised on ``mesh`` (or
    without one) -> (summary without latencies, digests, launches)."""
    import shutil

    from repro_torch.core.durability import shard_session_state
    from repro_torch.kernels.enrich_score import ops
    from repro_torch.launch import serve
    from repro_torch.runtime.chaos import parse_fault_spec
    from repro_torch.runtime.supervisor import Supervisor, SupervisorConfig

    root = SESSION_MESH_DIR / ("mesh" if mesh is not None else "free")
    shutil.rmtree(root, ignore_errors=True)
    session, state, pool, preds = _robust_world(plan_shards=2)
    if mesh is not None:
        state = shard_session_state(state, mesh)
    sup = Supervisor(session, state, serve.parse_trace(MAIN_TRACE), pool=pool, preds=preds,
                     checkpoint_dir=root, chunk_size=2, fault_plan=parse_fault_spec(
                         "kill:w1@chunk:4"), mesh=mesh,
                     config=SupervisorConfig(heartbeat_timeout=2.0, checkpoint_every=2,
                                             checkpoint_keep=3))
    ops.reset_counts()
    rep = sup.serve()
    launches = _es_counts(ops)
    assert not any(ops.PLAIN_CALLS.values()), dict(ops.PLAIN_CALLS)
    shutil.rmtree(root, ignore_errors=True)
    summary = {k: v for k, v in sup.summary().items() if k != "recovery_latency_s"}
    assert not rep.preempted and summary["shrinks"] == [[2, 1]], summary
    assert summary["final_state"] == "healthy" and summary["restarts"] == 1, summary
    runs = sup.session.program.program_runs
    assert runs["per_rank" if mesh is not None else "device"] > 0, runs
    return dict(summary=summary, digests=(rep.cost_hex, rep.bills_hex, rep.answer_digest),
                launches=launches)


def session_mesh_child() -> int:
    """Phase 9's child: a one-rank NCCL group, the (1, 1) mesh, phase 4's
    world on and off it."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.launch.mesh import make_host_mesh

    if not dist.is_nccl_available():
        raise RuntimeError("the session mesh phase runs on NCCL, which this torch lacks")
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}", rank=0,
                            world_size=1)
    try:
        mesh = make_host_mesh(model=1, device_type="cuda")
        # in turns, each on a fresh world: the first run also builds the kernels
        turns = [(name, _session_serve(mesh if name == "mesh" else None))
                 for name in ("free", "mesh", "mesh", "free")]
        for name, run in turns:
            for key in ("trace", "table"):
                assert run[key] == turns[0][1][key], (name, key, run[key], turns[0][1][key])
        on_mesh = turns[1][1]
        _session_staged(mesh, on_mesh["trace"])
        sup_free, sup_mesh = _session_supervised(None), _session_supervised(mesh)
        assert sup_mesh["summary"] == sup_free["summary"], (sup_mesh["summary"],
                                                            sup_free["summary"])
        assert sup_mesh["digests"] == sup_free["digests"] == on_mesh["trace"], "supervised"
    finally:
        dist.destroy_process_group()
    coll = on_mesh["table_collectives"]

    def both(key):  # the two runs of each, in the order they ran
        return {kind: [run[key] for name, run in turns if name == kind]
                for kind in ("mesh", "free")}

    line = {
        "card": _nvidia_smi(), "mesh": [1, 1], "rows": SESSION_ROWS,
        "turns": [name for name, _ in turns],
        "trace_epochs_per_s": both("trace_eps"), "table_epochs_per_s": both("table_eps"),
        "collectives_per_table_epoch": {k: v / 8 for k, v in coll.items()},
        "trace_collectives": on_mesh["trace_collectives"],
        "peak_bytes": both("peak_bytes"),
        "cost_hex": on_mesh["trace"][0], "answer_digest": on_mesh["trace"][2][:16],
        "supervised": {"shrinks": sup_mesh["summary"]["shrinks"],
                       "restored_steps": sup_mesh["summary"]["restored_steps"]},
    }
    print(f"[session-mesh] {json.dumps(line)}", flush=True)
    launches = {k: on_mesh["launches"][k] + sup_mesh["launches"][k] for k in on_mesh["launches"]}
    print(json.dumps({"launches": launches}))
    return 0


def phase_session_mesh() -> dict:
    """Phase 9: the session mesh's child -> the mesh runs' launches."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--session-mesh"],
                          capture_output=True, text=True, timeout=600)
    sys.stdout.write(proc.stdout)
    sys.stderr.write(proc.stderr[-4000:])
    if proc.returncode:
        raise AssertionError(f"the session mesh child exited {proc.returncode}")
    print(f"[session-mesh] phase 9 in {time.perf_counter() - t0:.1f} s", flush=True)
    return json.loads(proc.stdout.strip().splitlines()[-1])["launches"]


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# ------------------------------------------------------- serving robustness --

ROBUST_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_robust"
ROBUST_SMALL_TRACE = "admit:2;admit:3;run:4;ingest:2048;admit:2;run:4;retire:0;run:4"
ROBUST_BATCH = 65536  # streaming micro-batch rows: MAIN_TRACE's ingest is 8 of them


def _robust_world(plan_shards: int = 1):
    """Phase 4's world: 524,288 rows growing to 1,048,576, bf16, 8 slots."""
    from repro_torch.launch import serve

    return serve.build_session_server(
        num_objects=524288, capacity=524288, max_capacity=1 << 20, num_preds=P,
        max_tenants=8, substrate_dtype="bfloat16", plan_shards=plan_shards, device="cuda",
    )


def _same_digests(a, b, what: str) -> None:
    for key in ("cost_hex", "bills_hex", "answer_digest", "epochs_total"):
        assert getattr(a, key) == getattr(b, key), (
            f"{what}: {key} {getattr(a, key)!r} != {getattr(b, key)!r}")


def _stage_trace(pipe, events, pool, preds, seed: int = 0) -> None:
    """The serve loop's event staging on a pipeline (admits draw their
    predicates from ``default_rng(seed)`` as ``serve_session_trace`` does)."""
    import numpy as np

    from repro_torch.core.query import conjunction

    rng = np.random.default_rng(seed)
    off = 0
    for kind, arg in events:
        if kind == "run":
            pipe.run(arg)
        elif kind == "admit":
            cols = sorted(rng.choice(len(preds), size=min(arg, len(preds)), replace=False))
            pipe.admit(conjunction(*[preds[c] for c in cols]))
        elif kind == "ingest":
            pipe.ingest(pool[off:off + arg])
            off += arg
        else:
            pipe.retire(arg)


def _robust_counts(ops, what: str, best: int = None, table: int = 0) -> dict:
    launches, plain = _es_counts(ops), dict(ops.PLAIN_CALLS)
    assert not any(plain.values()), f"{what}: the plain path ran: {plain}"
    if best is not None:
        assert launches["enrich_score_best"] == best, (what, launches)
    else:
        assert launches["enrich_score_best"] > 0, (what, launches)
    assert launches["enrich_score_table"] == table, (what, launches)
    return launches


def _robust_overlap(ops, serve, events) -> dict:
    """Overlap vs lockstep at full size (digests equal, no extra chunk
    programs), the pipeline's staging under sync debug mode "error", and
    the grown state's table-mode epochs through a pipeline."""
    import torch

    from repro_torch.core.executor import EngineConfig
    from repro_torch.core.session import EngineSession

    launches = dict.fromkeys(_es_counts(ops), 0)
    reports = {}
    for name in ("lockstep", "overlap", "overlap ", "lockstep "):  # in turns
        session, state, pool, preds = _robust_world()
        ops.reset_counts()
        rep = serve.serve_session_trace(session, state, events, pool=pool, preds=preds,
                                        overlap=name.startswith("overlap"))
        for k, v in _robust_counts(ops, name, best=24).items():
            launches[k] += v
        reports[name] = (rep, session)
    control, c_session = reports["lockstep"]
    for name, (rep, session) in reports.items():
        _same_digests(rep, control, f"{name.strip()} vs lockstep")
        assert rep.superstep_traces <= control.superstep_traces, (name, rep.superstep_traces)
    rates = {name.strip(): [] for name in reports}
    for name, (rep, _) in reports.items():
        rates[name.strip()].append(rep.epochs / rep.wall_s)
    print(f"[robust] overlap vs lockstep: {control.epochs} epochs, digests equal "
          f"({control.cost_hex}, {control.answer_digest[:16]}), chunk programs "
          f"{reports['overlap'][0].superstep_traces} vs {control.superstep_traces}; epochs/s "
          f"(host clock, trace incl. churn events) lockstep {rates['lockstep']!r}, overlap "
          f"{rates['overlap']!r}", flush=True)

    # the staging itself, host pool (pinned copy path), under sync debug "error"
    session, state, pool, preds = _robust_world()
    host_pool = pool.cpu()
    ops.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe = session.pipeline(state)
    torch.cuda.set_sync_debug_mode("error")
    try:
        _stage_trace(pipe, events, host_pool, preds)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    staged_s = time.perf_counter() - t0
    grown, _ = pipe.finish()
    wall_s = time.perf_counter() - t0
    for k, v in _robust_counts(ops, "staged pipeline", best=24).items():
        launches[k] += v
    assert serve.state_digests(grown) == (control.cost_hex, control.bills_hex,
                                          control.answer_digest), "staged pipeline digests"
    print(f"[robust] pipeline staging of {len(events)} events raised nothing under "
          f"set_sync_debug_mode('error'); staged in {staged_s * 1e3:.1f} ms, finished "
          f"{wall_s * 1e3:.1f} ms after open; digests equal the lockstep run's", flush=True)

    # table mode (kernel 1) on the grown state: lockstep vs pipeline
    table_session = EngineSession(
        session.global_predicates, session.table, session.combine_params, session.costs,
        capacity=grown.capacity, max_tenants=8, device=session.device,
        config=EngineConfig(plan_size=64, substrate_dtype="bfloat16"),
    )
    ops.reset_counts()
    lock, _ = table_session.run(grown, 8, stop_when_exhausted=False)
    tpipe = table_session.pipeline(grown)
    tpipe.run(8)
    piped, _ = tpipe.finish()
    for k, v in _robust_counts(ops, "table mode", best=0, table=16).items():
        launches[k] += v
    assert serve.state_digests(lock) == serve.state_digests(piped), "table-mode pipeline digests"
    print("[robust] table mode on the grown state: 8 epochs lockstep and through a "
          "pipeline, digests equal", flush=True)
    return launches, control, c_session


def _robust_streaming(ops, serve, events, control) -> dict:
    """The ingest event through StreamingIngest (block under overlap, spill
    lockstep), digests equal to direct ingest; the feed's rate."""
    import torch

    from repro_torch.ingest import IngestStream, PendingRing

    launches = dict.fromkeys(_es_counts(ops), 0)
    for slots, policy, overlap in ((4, "block", True), (2, "spill", False)):
        session, state, pool, preds = _robust_world()
        streaming = serve.StreamingIngest(session, batch_rows=ROBUST_BATCH, num_slots=slots,
                                          policy=policy)
        ops.reset_counts()
        rep = serve.serve_session_trace(session, state, events, pool=pool.cpu(), preds=preds,
                                        overlap=overlap, streaming=streaming)
        for k, v in _robust_counts(ops, f"streaming {policy}", best=24).items():
            launches[k] += v
        _same_digests(rep, control, f"streaming {policy} vs direct ingest")
        c = rep.ingest_counters
        rows = sum(arg for kind, arg in events if kind == "ingest")
        batches = -(-rows // ROBUST_BATCH)
        assert c["rows_fed"] == c["drained_rows"] == rows and c["shed_rows"] == 0, c
        if policy == "block":  # a full ring drains once per `slots` batches
            assert c["blocked"] == (batches - 1) // slots and not c["spilled_rows"], c
        else:  # everything past the free slots spills, then refills FIFO
            assert c["spilled_batches"] == batches - slots and not c["blocked"], c
        print(f"[robust] streaming {policy} ({'overlap' if overlap else 'lockstep'}, batch "
              f"{ROBUST_BATCH} x {slots} slots): digests equal direct ingest; {rep.ring_drains} "
              f"drains, counters {c}", flush=True)

    # the feed's own rate: quantize f32 -> bf16 into pinned staging, copy on
    # the side stream, write the ring (8 slots: no drain in the timed region)
    session, state, pool, preds = _robust_world()
    rows = pool.cpu()
    ring = PendingRing(session, slot_rows=ROBUST_BATCH, num_slots=8, policy="block")
    stream = IngestStream(ring, batch_rows=ROBUST_BATCH)
    stream.feed(rows[:ROBUST_BATCH])  # warm-up: pinned blocks, side stream
    ring.drain_into(session, state, int(state.num_rows))
    times, nbytes = [], 0
    for _ in range(3):
        stream.bytes_staged = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stream.feed(rows)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        nbytes = stream.bytes_staged
        ring._head = ring._count = 0  # discard: the timing needs no drain
        ring._fill = [0] * ring.num_slots
    pinned = torch.empty(rows.shape, dtype=torch.bfloat16, pin_memory=True)
    pinned.copy_(rows)
    raw = []
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        pinned.to("cuda", non_blocking=True)
        end.record()
        end.synchronize()
        raw.append(start.elapsed_time(end) / 1e3)
    feed_gbs = nbytes / statistics.median(times) / 1e9
    raw_gbs = nbytes / statistics.median(raw) / 1e9
    print(f"[robust] feed of {rows.shape[0]} f32 rows as {nbytes} bf16 bytes (batches of "
          f"{ROBUST_BATCH}): "
          f"{statistics.median(times) * 1e3:.3f} ms median of 3 (host clock, synchronised) = "
          f"{feed_gbs:.3f} GB/s quantize + pinned copy + ring write; the bare pinned H2D "
          f"copy {statistics.median(raw) * 1e3:.3f} ms = {raw_gbs:.3f} GB/s (CUDA events)",
          flush=True)
    return launches


def _robust_resume(ops, serve, events, control) -> dict:
    """Preempt mid-trace from the boundary hook, restore on a fresh session,
    resume: digests and epochs_total equal the uninterrupted run's."""
    import shutil

    from repro_torch.core.durability import SessionCheckpointer, restore_session_checkpoint
    from repro_torch.runtime.fault_tolerance import PreemptionHandler

    launches = dict.fromkeys(_es_counts(ops), 0)
    root = ROBUST_DIR / "resume"
    shutil.rmtree(root, ignore_errors=True)
    session, state, pool, preds = _robust_world()
    ckpt = SessionCheckpointer(session, root, every=2, keep=3)
    stop = PreemptionHandler()
    ticks = [0]

    def hook():
        ticks[0] += 1
        if ticks[0] == 5:  # mid-trace: the second run event, after the ingest
            stop.request()

    ops.reset_counts()
    first = serve.serve_session_trace(session, state, events, pool=pool, preds=preds,
                                      preemption=stop, chunk_size=2, checkpointer=ckpt,
                                      boundary_hook=hook)
    assert first.preempted and first.epochs_total == 10, (first.preempted, first.epochs_total)
    for k, v in _robust_counts(ops, "preempted run", best=10).items():
        launches[k] += v
    session2, _, pool2, preds2 = _robust_world()
    t0 = time.perf_counter()
    restored, step, extra = restore_session_checkpoint(session2, root)
    restore_s = time.perf_counter() - t0
    ops.reset_counts()
    resumed = serve.serve_session_trace(session2, restored, events, pool=pool2, preds=preds2,
                                        chunk_size=2, resume=extra["host"])
    for k, v in _robust_counts(ops, "resumed run", best=14).items():
        launches[k] += v
    _same_digests(resumed, control, "resumed vs uninterrupted")
    per = ckpt.bytes_written / ckpt.saves
    print(f"[robust] preempted at boundary 5 (epoch {first.epochs_total}), restored step "
          f"{step} on a fresh session and resumed: digests and epochs_total "
          f"({resumed.epochs_total}) equal the uninterrupted run's; {ckpt.saves} saves of "
          f"{per:.0f} bytes, {ckpt.save_seconds / ckpt.saves * 1e3:.1f} ms a save, restore "
          f"{restore_s * 1e3:.1f} ms (host clock)", flush=True)
    shutil.rmtree(root, ignore_errors=True)
    return launches


def _robust_supervised(ops, serve, events, control) -> dict:
    """A killed plan shard (2 -> 1, healthy, digests equal a 2-shard
    control) and a raising enrichment function (1 shard, degraded)."""
    import shutil

    from repro_torch.runtime.chaos import parse_fault_spec
    from repro_torch.runtime.supervisor import Supervisor, SupervisorConfig

    launches = dict.fromkeys(_es_counts(ops), 0)
    session, state, pool, preds = _robust_world(plan_shards=2)
    ops.reset_counts()
    control2 = serve.serve_session_trace(session, state, events, pool=pool, preds=preds,
                                         chunk_size=2)
    for k, v in _robust_counts(ops, "2-shard control", best=24).items():
        launches[k] += v
    _same_digests(control2, control, "2-shard vs 1-shard planning")
    for spec, shards in (("kill:w1@chunk:4", 2), ("raise:p1.f2@chunk:4", 1)):
        root = ROBUST_DIR / "supervised"
        shutil.rmtree(root, ignore_errors=True)
        session, state, pool, preds = _robust_world(plan_shards=shards)
        sup = Supervisor(
            session, state, events, pool=pool, preds=preds, checkpoint_dir=root,
            chunk_size=2, fault_plan=parse_fault_spec(spec),
            config=SupervisorConfig(heartbeat_timeout=2.0, checkpoint_every=2,
                                    checkpoint_keep=3),
        )
        ops.reset_counts()
        rep = sup.serve()
        for k, v in _robust_counts(ops, spec).items():
            launches[k] += v
        s = sup.summary()
        assert not rep.preempted, spec
        if spec.startswith("kill"):
            assert s["final_state"] == "healthy" and s["shrinks"] == [[2, 1]], s
            assert s["failed_workers"] == [1] and s["restarts"] == 1, s
            assert [t[2] for t in s["transitions"]] == ["draining", "restoring", "healthy"], s
            _same_digests(rep, control2, "supervised kill vs 2-shard control")
        else:
            assert s["final_state"] == "degraded" and s["quarantined"] == [[1, 2]], s
            assert rep.degraded and rep.quarantined == [[1, 2]] and rep.mean_expected_f > 0
            assert s["restarts"] == 1 and s["function_failures"]["p1.f2"] >= 2, s
            assert s["shrinks"] == [], s
        print(f"[robust] supervised {spec!r} on {shards} shard(s): {s['final_state']}, "
              f"shrinks {s['shrinks']}, quarantined {s['quarantined']}, restarts "
              f"{s['restarts']}, restored steps {s['restored_steps']}, recovery latency "
              f"{[round(x * 1e3, 3) for x in s['recovery_latency_s']]} ms (host clock, "
              f"detection to the first chunk after restore), {s['checkpoint_saves_total']} "
              f"saves, mean E(F) {rep.mean_expected_f!r}", flush=True)
        shutil.rmtree(root, ignore_errors=True)
    return launches


def _robust_cpu_vs_gpu(serve) -> None:
    """Overlap + streaming and checkpoint / resume on the CPU and the card
    over phase 3's world: each mode equals its own device's lockstep run
    bitwise, and the card's answers equal the CPU's."""
    import shutil

    import numpy as np

    from repro_torch.core.durability import SessionCheckpointer, restore_session_checkpoint
    from repro_torch.core.executor import EngineConfig
    from repro_torch.core.query import Predicate
    from repro_torch.core.session import EngineSession
    from repro_torch.runtime.fault_tolerance import PreemptionHandler

    table, combine, costs, outputs = _small_world()
    preds = [Predicate(i, 1) for i in range(P)]
    events = serve.parse_trace(ROBUST_SMALL_TRACE)
    pool = outputs[2048:4096]
    results = {}
    for device in ("cpu", "cuda"):
        def fresh():
            s = EngineSession(preds, table, combine, costs, capacity=2048, max_tenants=4,
                              max_capacity=4096, device=device,
                              config=EngineConfig(plan_size=64, function_selection="best"))
            return s, s.init_state(outputs[:2048])

        s, st = fresh()
        lock = serve.serve_session_trace(s, st, events, pool=pool, preds=preds)
        s, st = fresh()
        streaming = serve.StreamingIngest(s, batch_rows=512, num_slots=2, policy="block")
        over = serve.serve_session_trace(s, st, events, pool=pool, preds=preds, overlap=True,
                                         streaming=streaming)
        _same_digests(over, lock, f"{device}: overlap + streaming vs lockstep")
        root = ROBUST_DIR / f"small_{device}"
        shutil.rmtree(root, ignore_errors=True)
        s, st = fresh()
        stop = PreemptionHandler()
        ticks = [0]

        def hook():
            ticks[0] += 1
            if ticks[0] == 3:
                stop.request()

        first = serve.serve_session_trace(
            s, st, events, pool=pool, preds=preds, preemption=stop, chunk_size=2,
            checkpointer=SessionCheckpointer(s, root, every=2), boundary_hook=hook)
        assert first.preempted
        s, _ = fresh()
        restored, _, extra = restore_session_checkpoint(s, root)
        resumed = serve.serve_session_trace(s, restored, events, pool=pool, preds=preds,
                                            chunk_size=2, resume=extra["host"])
        _same_digests(resumed, lock, f"{device}: resumed vs lockstep")
        shutil.rmtree(root, ignore_errors=True)
        results[device] = lock
    cpu, gpu = results["cpu"], results["cuda"]
    assert gpu.answer_digest == cpu.answer_digest, "CPU and card answers differ"
    assert (gpu.epochs, gpu.num_rows, gpu.growths) == (cpu.epochs, cpu.num_rows, cpu.growths)
    np.testing.assert_allclose(gpu.cost_spent, cpu.cost_spent, rtol=1e-5)
    np.testing.assert_allclose([float.fromhex(h) for h in gpu.bills_hex],
                               [float.fromhex(h) for h in cpu.bills_hex], rtol=1e-5, atol=1e-6)
    print(f"[robust] CPU vs card ({ROBUST_SMALL_TRACE!r}, 2048 -> 4096 rows): overlap + "
          f"streaming and preempt / resume equal each device's lockstep run bitwise; answer "
          f"digests equal across devices ({gpu.answer_digest[:16]}), spend {cpu.cost_spent!r} "
          f"vs {gpu.cost_spent!r} (cost_hex {'equal' if cpu.cost_hex == gpu.cost_hex else 'differs'})",
          flush=True)


def phase_serving_robustness() -> dict:
    """Overlap, streaming, preempt / resume and supervised serving at the
    session cell's size, each against a lockstep control from the same
    seed; then the same modes CPU vs card at phase 3's size."""
    import shutil

    from repro_torch.kernels.enrich_score import ops
    from repro_torch.launch import serve

    t0 = time.perf_counter()
    events = serve.parse_trace(MAIN_TRACE)
    runs = []
    launches, control, _ = _robust_overlap(ops, serve, events)
    runs.append(launches)
    runs.append(_robust_streaming(ops, serve, events, control))
    runs.append(_robust_resume(ops, serve, events, control))
    runs.append(_robust_supervised(ops, serve, events, control))
    _robust_cpu_vs_gpu(serve)
    shutil.rmtree(ROBUST_DIR, ignore_errors=True)
    total = {k: sum(r.get(k, 0) for r in runs) for k in _es_counts(ops)}
    print(f"[robust] all parts passed in {time.perf_counter() - t0:.1f} s; launches {total}",
          flush=True)
    return total


def _laps():
    """-> lap(name): prints the seconds since the previous lap (or this
    call) and the script's time so far, on a ``[time]`` line."""
    last = [time.perf_counter()]

    def lap(name: str) -> None:
        now = time.perf_counter()
        print(f"[time] {name}: {now - last[0]:.1f} s (the script at {now - T_START:.1f} s)",
              flush=True)
        last[0] = now
    return lap


def main() -> int:
    import torch

    if sys.argv[1:] == ["--mesh-gloo"]:  # phase 8's CPU-only child (no card in its view)
        return mesh_gloo_child()

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a GPU",
              file=sys.stderr)
        return 2
    if sys.argv[1:] == ["--train-resume"]:  # phase_train_resume's child process
        return train_resume_child()
    if sys.argv[1:] == ["--model-mesh"]:  # phase_model_mesh's child
        return model_mesh_child()
    if sys.argv[1:] == ["--session-mesh"]:  # phase_session_mesh's child
        return session_mesh_child()
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)
    from repro_torch.quickstart import quickstart_world

    smi = _nvidia_smi()
    print(f"[env] {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    lap = _laps()
    phase_build()
    lap("build")
    gloo = start_mesh_gloo()  # phase 8's CPU checks, beside the card phases
    atexit.register(lambda: gloo[0].poll() is None and gloo[0].kill())
    table, combine, costs, outputs = _small_world()
    results = phase_kernels(table, costs)
    quickstart = quickstart_world(4096, device="cpu")
    results["enrich_score_single"] = phase_single_kernel(quickstart["table"])
    world8 = _small_world(SESSION8_AUCS, SESSION8_COSTS)  # eight functions: "global" tables
    global_route = phase_global_tables(world8[0], world8[2])
    world10 = _small_world(SESSION10_AUCS, SESSION10_COSTS, learn_on="cuda")  # ten functions
    lap("2 scoring kernels")
    flash = phase_flash()
    for route, name in (("simt", "flash_attention"), ("tc", "flash_attention_tc"),
                        ("short", "flash_attention_short"), ("split", "flash_attention_split")):
        results[name] = flash[route]
    lap("2 flash")
    (results["decode_attention_partials"], results["decode_attention_partials_tc"],
     results["decode_attention_fused"]) = phase_decode()
    lap("2 decode")
    results["ssd_intra_chunk"], results["ssd_intra_chunk_tc"] = phase_ssd()
    results["ssd_inter_chunk"] = phase_ssd_inter()
    lap("2 ssd")
    results.update(phase_mixer())
    lap("2 mixer")
    phase_cpu_vs_gpu(table, combine, costs, outputs)
    phase_cascade_cpu_vs_gpu("qwen3-1.7b")
    phase_cascade_cpu_vs_gpu("mamba2-370m")
    phase_operator_cpu_vs_gpu(quickstart)
    lap("3 session, cascades, operator: CPU vs card")
    phase_serve_cpu_vs_gpu()
    phase_serve_bf16_cpu_vs_gpu()
    phase_moe_cpu_vs_gpu()
    lap("3 serve, bf16, moe: CPU vs card")
    phase_cascade_bf16_cpu_vs_gpu()
    lap("3 cascade bf16")
    runs = [phase_main_path(), phase_session_functions(world8, 8),
            phase_session_functions(world10, 10)]
    lap("4 main path, 4a")
    runs.append(phase_serving_robustness())
    lap("4b robustness")
    runs += [phase_cascade_main_path("qwen3-1.7b"), phase_cascade_main_path("mamba2-370m"),
             phase_cascade_main_path("hymba-1.5b")]
    lap("5 cascades")
    runs += [phase_operator_main_path(), phase_serve_entry_points(), phase_model_serve()]
    lap("6, 7 operator, entry points, model serve")
    runs.append(phase_zoo_serve())
    lap("7b zoo")
    phase_train_cpu_vs_gpu()
    train_run = phase_train_main_path()
    train_run["resume"] = phase_train_resume()
    lap("7c train")
    runs.append(phase_model_mesh(gloo))
    lap("8 model mesh")
    runs.append(phase_session_mesh())
    lap("9 session mesh")
    cell_launches, cell_rows = phase_long_cells()
    lap("9b long cells")
    runs.append(cell_launches)
    for name, rows in cell_rows.items():  # the cells' shapes beside the zoo's
        results[name].setdefault("shapes", []).extend(rows)
    # launches: the sum over the main-path runs (each zeroes the counts first)
    kernels = [
        dict(name=name, route="cuda", source=SOURCES[name], replaces=REPLACES[name],
             launches=sum(run.get(key, 0) for run in runs for key in COUNTED.get(name, (name,))),
             max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
             bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=r.get("library_ms"),
             **({"shapes": r["shapes"]} if "shapes" in r else {}))
        for name, r in results.items()
    ]
    missing = [k["name"] for k in kernels if not k["launches"] and k["name"] not in OFF_PATH]
    assert not missing, f"kernels of the main paths launched no time there: {missing}"
    by_name = {k["name"]: k for k in kernels}
    for name, glob in global_route.items():  # the scoring kernels' launches by table route
        routes = {r: sum(run.get(f"{name}/{r}", 0) for run in runs) for r in ("smem", "global")}
        assert sum(routes.values()) == by_name[name]["launches"], (name, routes)
        by_name[name].update(routes=routes, global_route=glob)
    by_name["flash_attention"].update(
        prefill_ms=results["flash_attention"]["prefill_ms"],
        prefill_bound_ms=results["flash_attention"]["prefill_bound_ms"],
        prefill_library_ms=results["flash_attention"]["prefill_library_ms"],
        routes={r: sum(run.get(f"flash_attention/{r}", 0) for run in runs)
                for r in ("tc", "short", "split", "simt")})
    for name in ("flash_attention_tc", "flash_attention_short", "flash_attention_split",
                 "flash_attention", "decode_attention_fused", "decode_attention_partials",
                 "decode_attention_partials_tc"):
        by_name[name]["softcap"] = results[name]["softcap"]
    by_name["ssd_intra_chunk"].update(
        prefill_simt_ms=results["ssd_intra_chunk"]["prefill_simt_ms"],
        prefill_bound_ms=results["ssd_intra_chunk"]["prefill_bound_ms"],
        routes={r: sum(run.get(f"ssd_intra_chunk/{r}", 0) for run in runs)
                for r in ("tc", "simt", "packed")})
    for name in MIXER_KERNELS:  # the contract against the twin, as measured at the row's shape
        by_name[name].update({k: results[name][k] for k in (
            "values_apart", "share_apart", "most_ulps") if k in results[name]})
    by_name["decode_attention_partials_tc"].update(
        with_combine_ms=results["decode_attention_partials_tc"]["with_combine_ms"],
        simt_ms=results["decode_attention_partials_tc"]["simt_ms"])
    by_name["decode_attention_partials"].update(  # the simt form at the tc form's row
        tc_ms=results["decode_attention_partials"]["tc_ms"])
    by_name["decode_attention_fused"].update(
        host_ms=results["decode_attention_fused"]["host_ms"],
        routes={r: sum(run.get(f"decode_attention_fused/{r}", 0) for run in runs)
                for r in ("tc", "simt", "split")})
    by_name["flash_attention_split"].update(short_ms=results["flash_attention_split"]["short_ms"])
    print(f"[train] {json.dumps(train_run)}", flush=True)
    print(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s (the script: "
          f"{time.perf_counter() - T_START:.1f} s of its 1,200)", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
